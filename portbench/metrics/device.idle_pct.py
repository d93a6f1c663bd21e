"""The device's idle share: the part of the traced stretch in which no
kernel, copy or memset ran on the card, in %."""
from portbench.harness.trace import union_ns


def read(run):
    tr = run.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    return 100.0 * (1.0 - union_ns(tr.busy, tr.t0, tr.t1) / (tr.t1 - tr.t0))
