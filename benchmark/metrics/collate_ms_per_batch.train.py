"""Host ms a batch of the loader's collate (``data/dataflow.py::
HostDataLoader._collate``, in its producer thread): the program's
``data.collate`` counter, seconds over count, over the whole run."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    c = spans.counter("data.collate")
    if not c or not c["count"]:
        return None
    return 1e3 * c["seconds"] / c["count"]
