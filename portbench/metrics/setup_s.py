"""Set-up: from the process's start to the window's opening, in s
(imports, kernel library, weights, models, prompts, length scale,
warm-up)."""


def read(run):
    return run.setup_s
