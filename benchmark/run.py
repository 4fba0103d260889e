"""The benchmark of ``selfrec_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. Prints the run's sample counts, then as the last line of
standard output one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit); the same checks are
the last lines of standard error. Exits non-zero, printing no result,
when CUDA or the cell's cards are missing, when the program is not in the
checkout, or when JAX or the JAX package is loaded once the window has
closed. Every cache of the program's builds lives under ``build/`` of the
checkout."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment(env: dict) -> None:
    """The program's knobs as the configuration runs them, one thread for
    the host's math libraries (one process with few threads keeps the
    host side steady on a machine whose cores are shared), and every build
    and kernel cache at a fixed path inside the checkout."""
    for key in [k for k in os.environ if k.startswith("SELFREC_TPU_")]:
        del os.environ[key]
    build = os.path.join(ROOT, "build")
    os.environ.update({"SELFREC_TPU_TORCH_BUILD": os.path.join(build, "kernels"),
                       "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
                       "TRITON_CACHE_DIR": os.path.join(build, "triton"),
                       "CUDA_CACHE_PATH": os.path.join(build, "cuda_cache"),
                       "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                       "OPENBLAS_NUM_THREADS": "1", "USE_FLAX": "0"})
    os.environ.update(env)


def plain(x):
    """JSON without NaN or infinity: a number that is not finite as text."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def report(out: dict) -> None:
    samples = out.pop("samples")
    print("[samples] " + " ".join(f"{k}={v}" for k, v in samples.items()), flush=True)
    sys.stdout.write(json.dumps(plain(out)) + "\n")
    sys.stdout.flush()
    for name, (number, limit) in out["checks"].items():
        sys.stderr.write(f"[check] {name} {number!r} limit {limit!r}\n")
    sys.stderr.flush()


def main(argv=None, extra_env=None, control=False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.core import registry

    cell = registry.cell(args.workload)
    environment({**cell.config.get("env", {}), **(extra_env or {})})
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"{args.workload} needs {cell.chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    from benchmark.core import harness

    report(harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                       control=control))
    return 0


if __name__ == "__main__":
    sys.exit(main())
