"""Mean host ms of the window's GETs (``FeatureStore.get_online_features``:
the serving front, the online store, the lookup kernel), one a batch."""


def read(run):
    gets = run.spans.get("get", [])
    return 1e3 * sum(gets) / len(gets) if gets else None
