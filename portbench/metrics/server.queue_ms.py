"""Queue wait from the server's own counters: TTSServer.stats()'s
queue_s_sum over its rows at the server's close, in ms; each request's
time from submit to the start of the call that serves it, over every
request the server served: the window, the drain after it and the cell's
warm-up calls (16 rows, about 2 % of them)."""
from portbench.harness import gaps


def read(run):
    stats = gaps.found(run)["stats"]
    if stats is None:
        return None
    return gaps.queue_ms({"rows": 0, "queue_s_sum": 0.0}, stats)
