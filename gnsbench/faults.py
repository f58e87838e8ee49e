"""Faults planted in the program's timed path, one at a time, to show that
``correct`` comes out false when the path breaks.  Each is a context
manager that patches the port while it is open.  A training cell on one
chip can have three: a step that leaves the state unchanged, half of the
batch left out of the loss (the mean taken over the rest), and an answer
altered where it is produced (one lane weight of the host sampler's
output doubled).  One chip has no exchange between chips to leave out.
A fourth breaks the cache draw the cells' ``why`` names: the most
probable nodes cached instead of a draw by their probabilities."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged_state():
    """AdamW returns the parameters and its state as they came."""
    from repro_torch.optim.adam import AdamW
    return _patched(AdamW, "update",
                    lambda orig: lambda self, grads, state, params, plans=None:
                    (params, state))


def half_batch():
    """The loss and its gradients over the first half of the labels."""
    from repro_torch.models import graphsage

    def make(orig):
        def loss_fn(params, batch, *args, **kwargs):
            mask = batch.label_mask.clone()
            mask[mask.shape[0] // 2:] = 0
            return orig(params, dataclasses.replace(batch, label_mask=mask),
                        *args, **kwargs)
        return loss_fn
    return _patched(graphsage, "loss_fn", make)


def altered_answer():
    """The host sampler's first live lane of the top block doubled."""
    from repro_torch.sampling.device_sampler import DeviceGNSSampler

    def make(orig):
        def sample(self, targets, rng):
            mb = orig(self, targets, rng)
            w = mb.device.blocks[-1].nbr_w
            r, k = np.argwhere(w != 0)[0]
            w[r, k] *= 2.0
            return mb
        return sample
    return _patched(DeviceGNSSampler, "sample", make)


def top_k_cache():
    """Each cache generation holds the nodes of highest probability
    instead of a draw by the §3.2 distribution; the importance weights
    stay those of the draw."""
    from repro_torch.featurestore import store

    def make(orig):
        def sample_cache(*args, **kwargs):
            state = orig(*args, **kwargs)
            size = len(state.node_ids)
            ids = np.sort(np.argsort(-state.probs, kind="stable")[:size])
            in_cache = np.zeros_like(state.in_cache)
            in_cache[ids] = True
            slot_of = np.full_like(state.slot_of, -1)
            slot_of[ids] = np.arange(size, dtype=slot_of.dtype)
            return dataclasses.replace(state, node_ids=ids.astype(np.int64),
                                       in_cache=in_cache, slot_of=slot_of)
        return sample_cache
    return _patched(store, "sample_cache", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "top_k_cache": top_k_cache}
