"""Model operations of the window's evaluations over its seconds, against the
peak of the compute type (counts.transfer_eval_ops)."""

from portbench import counts
from portbench.readers import mfu


def read(t):
    return mfu(t, counts.transfer_eval_ops(t.context["rows"], t.context["config"]))
