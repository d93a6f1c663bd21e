"""Queue wait: the mean, over the window's served requests, of the time
from when a request was due (open loop) or sent (closed loop) to the start
of the pipeline call that served it, in ms."""


def read(run):
    start = {}
    for c in run.calls:
        for key in c.keys:
            start[key] = c.t0
    waits = [start[k] - s.due for s in run.sent
             if s.ok and (k := (run.text_of(s.req), s.req.voice)) in start]
    return 1e3 * sum(waits) / len(waits) if waits else None
