"""setup_s: seconds from the start of the process to the start of the
window (imports, data, the program's build, kernel builds on a first run,
the check steps or warm-up evals with their captures). Host clock."""


def read(run):
    return run.setup_s
