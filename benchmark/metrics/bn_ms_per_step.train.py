"""Device ms a step of the replayed train graph's kernels that its capture
map labels ``model.bn`` (train-mode BN's forward and backward,
``models/norm.py``), in the traced stretch: each replay's kernels matched
to the map's kernel nodes. Nothing to read when a replay's kernels or
their names disagree with the map, or the profile holds other than whole
replays."""

from benchmark import spans


def read(ctx):
    t = ctx.trace
    if ctx.kind != "train" or t is None or not t.units:
        return None
    got = spans.labelled_replays(t)
    if got is None or len(got) * spans.capture_map()["k"] != t.units:
        return None
    ms = sum(float(e["dur"]) for rep in got for e, label in rep
             if label == "model.bn") / 1e3
    return ms / t.units
