"""Faults planted underneath a run of a training cell, to show that
``correct`` comes out false: each takes the built trainer and breaks its
timed path on the instance. ``calibrate.py --fault`` reads them on the chip,
``tests/test_perfbench_correct.py`` on the CPU."""

import numpy as np


def unchanged(trainer):
    """A step that returns its state unchanged."""
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer):
    """Half of the batch left out of the update, the mean taken over the rest."""
    inner = trainer.update_actor

    def update(batch):
        return inner(batch.select(np.arange(len(batch) // 2)))

    trainer.update_actor = update


def altered(trainer):
    """Answers altered where they are produced: one log-prob and one advantage."""
    log_probs, advantages = trainer.compute_log_probs_batched, trainer.compute_advantages

    def altered_log_probs(batch, model):
        out = log_probs(batch, model)
        out[0, 0] += 0.5
        return out

    def altered_advantages(batch):
        adv, ret = advantages(batch)
        adv[0] += 0.5
        return adv, ret

    trainer.compute_log_probs_batched = altered_log_probs
    trainer.compute_advantages = altered_advantages


def resplit(trainer):
    """The update's samples split otherwise than the configuration says:
    micro-batches of half its rows."""
    actor = trainer.config.worker.actor
    actor.micro_batch_size_per_device_for_update = max(actor.micro_batch_size_per_device_for_update // 2, 1)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered, resplit)}
