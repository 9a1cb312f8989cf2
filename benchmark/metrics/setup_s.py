"""Set-up seconds: process start, kernel load (and build), inputs, warm-up."""


def read(run):
    return run.setup_s
