"""Social test data shared by the port's social tests: the relations of
tests/test_social.py's ``tiny_social_dataset`` (social links mostly within
the user groups of ``tiny_graph_dataset``), and a config for MHCN or SEPT."""

import numpy as np


def social_relations():
    rng = np.random.default_rng(5)
    relations = []
    for u in range(40):
        g = u % 4
        peers = [v for v in range(40) if v % 4 == g and v != u]
        for v in rng.choice(peers, size=4, replace=False):
            relations.append((f"u{u}", f"u{v}", 1.0))
        out = rng.choice([v for v in range(40) if v % 4 != g], size=1)
        relations.append((f"u{u}", f"u{out[0]}", 1.0))
    return relations


def social_conf_dict(name, extra, **top):
    conf = {
        "training.set": "<memory>", "test.set": "<memory>", "social.data": "<memory>",
        "model": {"name": name, "type": "graph"},
        "item.ranking.topN": [5, 10], "embedding.size": 16, "max.epoch": 6,
        "batch.size": 64, "learning.rate": 0.05, "reg.lambda": 0.0001,
        "output": "/tmp/selfrec_tpu_test_results/", "seed": 42, name: extra,
    }
    conf.update({k.replace("_", "."): v for k, v in top.items()})
    return conf


MHCN_EXTRA = {"n_layer": 2, "ss_rate": 0.01}
SEPT_EXTRA = {"n_layer": 2, "ss_rate": 0.005, "drop_rate": 0.3, "ins_cnt": 5}


def padded_batch(data, batch_size, n_valid, seed=0):
    """(u, i, j, mask) numpy arrays: ``n_valid`` training edges, then
    padding rows."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(data.edge_users), n_valid, replace=False)
    u = np.zeros(batch_size, np.int32)
    i = np.zeros(batch_size, np.int32)
    u[:n_valid] = data.edge_users[pick]
    i[:n_valid] = data.edge_items[pick]
    j = rng.integers(0, data.item_num, batch_size).astype(np.int32)
    mask = (np.arange(batch_size) < n_valid).astype(np.float32)
    return {"u": u, "i": i, "j": j, "mask": mask}
