"""Model operations of the window's steps over its seconds, against the
peak of the compute type (counts.train_model_ops: no recompute)."""

from portbench import counts
from portbench.readers import mfu


def read(t):
    ctx = t.context
    return mfu(t, counts.train_model_ops(ctx["rows"], ctx["config"]))
