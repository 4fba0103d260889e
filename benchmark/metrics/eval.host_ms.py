"""eval.host_ms: ms an eval spends on the host from the ranked ids to the
metric values: metrics.ranking_evaluation_ids for the graph models;
test()'s lists after top_items plus metrics.ranking_evaluation for the
sequential ones. Host-clock spans of the traced run."""


def read(run):
    n = len(run.rec["evals_s"])
    if not n or "eval.host" not in run.spans.total:
        return None
    return 1e3 * run.spans.total["eval.host"] / n
