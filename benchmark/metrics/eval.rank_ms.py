"""eval.rank_ms: ms an eval spends ranking, ending in a synchronise:
embeddings() plus ranking.topk_ids_from_embeddings for the graph models,
top_items for the sequential ones. Host-clock spans that the harness puts
around those calls in the traced run."""


def read(run):
    n = len(run.rec["evals_s"])
    if not n or "eval.rank" not in run.spans.total:
        return None
    return 1e3 * run.spans.total["eval.rank"] / n
