"""train_pairs_per_s: positive (user, item) pairs of all whole epochs in
the window over all their time, each epoch's batches, begin_epoch,
warm-up and capture included. Host clock, each epoch ending in a
synchronise. Graph trainer cells only."""


def read(run):
    rec = run.rec
    if run.family.SAMPLES != "pairs" or not rec["epochs"]:
        return None
    return rec["train_samples"] / rec["train_s"]
