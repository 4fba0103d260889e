"""Command-line entry point of the port, mirroring ``main.py``:

    python -m selfrec_tpu_torch --conf conf/SimGCL.yaml --set max.epoch=5
    python -m selfrec_tpu_torch --model SimGCL --device cpu
    torchrun --nproc-per-node 2 -m selfrec_tpu_torch --conf conf/SimGCL.yaml \
        --set distributed=true --set mesh.model=2

Runs on ``cuda`` unless ``--device`` says otherwise; under torchrun each
process on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import os
import time

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import MODEL_REGISTRY
from selfrec_tpu_torch.session import SelfRecTorch, available_models

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "conf")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", help="model name (uses conf/<model>.yaml)")
    parser.add_argument("--conf", help="path to a YAML config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set SimGCL.lambda=0.2")
    args = parser.parse_args(argv)

    conf_path = args.conf
    if not conf_path:
        if args.model not in MODEL_REGISTRY:
            parser.error(f"give --conf or --model, one of: "
                         f"{', '.join(available_models())}")
        conf_path = os.path.join(CONF_DIR, f"{args.model}.yaml")

    overrides = {}
    for item in args.set:
        key, sep, value = item.partition("=")
        if not sep:
            parser.error(f"--set expects KEY=VALUE, got {item!r}")
        overrides[key] = value

    s = time.time()
    SelfRecTorch(ModelConf(conf_path, overrides=overrides),
                 device=args.device).execute()
    print("Running time: %f s" % (time.time() - s))


if __name__ == "__main__":
    main()
