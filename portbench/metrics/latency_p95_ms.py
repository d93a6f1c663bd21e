"""Tail latency: the nearest-rank 95th percentile over every request due
in the window, from when it was due to its waveform's return, in ms. A
request that failed or had not returned by the end of the drain sits above
every other (read as the drain's end, if the percentile falls on one)."""
import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def read(run):
    if not run.sent:
        return None
    value = percentile([(s.done - s.due) if s.ok else math.inf for s in run.sent], 95)
    if math.isinf(value):
        value = run.t_end + run.drain - min(s.due for s in run.sent)
    return 1e3 * value
