"""Rows per pipeline call: the mean batch the server's grouping made in
the window (counted by the benchmark's recorder at the pipeline's entry)."""


def read(run):
    calls = [c for c in run.calls if c.ok]
    return sum(len(c.keys) for c in calls) / len(calls) if calls else None
