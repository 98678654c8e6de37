"""Faults planted under the timed path, for the tests that must see
``correct`` come out false (``test_fsbench_run.py``) and for the readings
that limits are set from (``calibrate.py --fault``).  Each takes ``patch``,
a ``setattr`` (pytest's ``monkeypatch.setattr`` in the tests), and replaces
one function of the program."""

import torch

def alter_get(patch):
    """An answer of the GET altered where the store produces it."""
    from repro_torch.core.featurestore import FeatureStore

    real = FeatureStore.get_online_features

    def altered(self, *a, **kw):
        vals, found = real(self, *a, **kw)
        vals = vals.copy()
        vals[found, 0] += 1
        return vals, found

    patch(FeatureStore, "get_online_features", altered)


def skip_materialization(patch):
    """The store's scheduled job returns its state unchanged."""
    from repro_torch.core.featurestore import FeatureStore

    patch(FeatureStore, "tick", lambda self, now=None: {})


def alter_token(patch):
    """Served tokens altered where the forward produces them: the worst
    token put first at every 16th position of every request, its last
    (the first token) among them.  (One position in 2,048 alone moves a
    mean gap by 1/2,048 of its own: PERF.md.)"""
    from repro_torch.models import api

    real = api.forward_logits

    def altered(params, batch, cfg):
        logits = real(params, batch, cfg).clone()
        pos = torch.arange(logits.shape[1] - 1, -1, -16)
        worst = logits[:, pos].argmin(-1, keepdim=True)
        logits[:, pos] = logits[:, pos].scatter(-1, worst, 1e4)
        return logits

    patch(api, "forward_logits", altered)


def half_batch(patch):
    """Half of the batch left out: the other half's logits served for it."""
    from repro_torch.models import api

    real = api.forward_logits

    def half(params, batch, cfg):
        tokens = batch["tokens"]
        kept = real(params, {"tokens": tokens[: len(tokens) // 2]}, cfg)
        return torch.cat([kept, kept])

    patch(api, "forward_logits", half)


def alter_batch_token(patch):
    """A token of the point-in-time batch altered where the loader
    produces it."""
    from repro_torch.data.loader import FeatureStoreLoader

    real = FeatureStoreLoader.sample_batch

    def altered(self, step):
        batch = real(self, step)
        batch["tokens"] = batch["tokens"].copy()
        batch["tokens"][0, -1] += 1
        return batch

    patch(FeatureStoreLoader, "sample_batch", altered)


def state_unchanged(patch):
    """A train step that returns its state unchanged."""
    from repro_torch.launch import steps

    def make(cfg, optimizer, **kw):
        def step(state, batch):
            metrics, _ = steps.loss_and_grads(state.params, batch, cfg)
            return state, metrics
        return step

    patch(steps, "make_train_step", make)


def train_half_batch(patch):
    """Half of each batch left out, the loss the mean over the rest."""
    from repro_torch.launch import steps

    real = steps.make_train_step

    def make(cfg, optimizer, **kw):
        step = real(cfg, optimizer, **kw)
        return lambda state, batch: step(
            state, {"tokens": batch["tokens"][: len(batch["tokens"]) // 2]})

    patch(steps, "make_train_step", make)


BY_KIND = {
    "session_prefill": [alter_get, skip_materialization, alter_token, half_batch],
    "pit_train": [alter_batch_token, state_unchanged, train_half_batch],
}
BY_NAME = {f.__name__: f for fs in BY_KIND.values() for f in fs}
