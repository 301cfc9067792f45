"""Set-up seconds: from the harness's start to the window's, with the
imports, the card's context, the kernel library's build or load, the
mix's inputs and the warm-up episode."""

UNIT = "s"


def read(run):
    return run.setup_s
