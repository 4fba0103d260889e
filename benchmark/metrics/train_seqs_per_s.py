"""train_seqs_per_s: training sequences of all whole epochs in the window
over all their time. Host clock, each epoch ending in a synchronise.
Sequential trainer cells only."""


def read(run):
    rec = run.rec
    if run.family.SAMPLES != "seqs" or not rec["epochs"]:
        return None
    return rec["train_samples"] / rec["train_s"]
