"""K8f (with its sum of the partial grams) and K8b of the evaluations: the
summed per-launch bounds (counts_layer_gram) over their device time. A
program without the kernels reads nothing."""

from portbench import counts_layer_gram
from portbench.readers import roofline
from portbench.spans import EVAL_RANGE

# Fragments of the kernels' names (csrc/gram.cu); K5/K6's readers match
# gram_fwd, gram_bwd and gram_reduce, which these do not contain.
FWD, SUM, BWD = "gram_layer_fwd", "gram_layer_sum", "gram_layer_bwd"


def launched(t, fragment: str) -> list:
    return t.launched_in(EVAL_RANGE, [e for e in t.kernels if fragment in e["name"]])


def read(t):
    fwd, sums, bwd = (launched(t, f) for f in (FWD, SUM, BWD))
    if not fwd or not bwd:
        return None
    bound = counts_layer_gram.layer_gram_eval_bound_s(t.context["rows"], t.context["config"],
                                                      len(fwd), len(bwd))
    return roofline(bound, fwd + sums + bwd)
