"""The check's control for one cell, on the card: a run at the cell's own
size, and besides its own numbers the readings that set the upper ends of
the limits.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

Where the configuration names a path of the program in the next lower
precision (``control.env``, e.g. SimGCL's int8 operands), the run itself
takes that path and its ``checks`` are the control's readings. Where it
names ``control.reference_tf32``, the reference computed in TF32 is put in
the program's place (``control.control``). Either way the result adds the
faults planted in the reference put in the program's place: half of each
batch left out, the state left unchanged (reads 1 by its measure) and the
first ranked answer of every row altered. The benchmark's own runs do not
run this."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark import run as bench
    from benchmark.core import registry

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    name = ap.parse_known_args()[0].workload
    bench.T0 = T0
    sys.exit(bench.main(extra_env=registry.cell(name).config["control"].get("env", {}),
                        control=True))
