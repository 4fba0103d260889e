"""eval_ms: the window's total eval time over its number of evals; one
eval is fast_evaluation over every test user (graph models: with the
embeddings() it ranks). Host clock, each eval ending in a synchronise."""


def read(run):
    evals = run.rec["evals_s"]
    return 1e3 * sum(evals) / len(evals) if evals else None
