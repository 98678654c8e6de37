"""Mean host ms of the window's point-in-time batches
(``FeatureStoreLoader.sample_batch`` over the offline store, and the
tokens' upload), one a step."""


def read(run):
    got = run.spans.get("batch", [])
    return 1e3 * sum(got) / len(got) if got else None
