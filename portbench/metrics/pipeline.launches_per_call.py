"""Device kernels a pipeline call launches: kernels in the traced stretch
over the pipeline calls in it."""


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    return len(run.trace.kernels) / len(run.traced_calls)
