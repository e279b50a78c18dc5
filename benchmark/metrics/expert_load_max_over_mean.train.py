"""The routers' load in the last traced step: over the expert layers, the
largest of each layer's heaviest expert's rows over the mean rows an
expert (1 where the routing is even).  Read from the counter each routing
layer of the port keeps on the device (``ops/moe.py``: ``LAYERS``, each
layer's ``rows``), once, after the trace; nothing where the port has no
such layer."""


def read(run):
    if run.trace is None:
        return None
    try:
        from guitar_tablature_classification_tpu_torch.ops import moe
    except ImportError:
        return None
    loads = [layer.rows.float() for layer in list(getattr(moe, "LAYERS", ()))]
    loads = [r for r in loads if float(r.sum()) > 0]
    if not loads:
        return None
    return max(float(r.max() / r.mean()) for r in loads)
