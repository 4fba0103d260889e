"""Nothing the benchmark loads is JAX, Flax or the JAX package, compared
by whole top-level names (the port's name only begins like the JAX
package's), and the plain references load nothing of the port at all."""

import os
import subprocess
import sys

from _small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "selfrec_tpu"}

PROBE = """
import sys, time
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().splitlines()[-1].split())


def test_references_load_nothing_of_either_package():
    tops = _tops("import benchmark.reference.simgcl, benchmark.reference.sasrec, "
                 "benchmark.reference.judge, benchmark.reference.synth")
    assert not tops & (FORBIDDEN | {"selfrec_tpu_torch"})


def test_a_whole_run_loads_no_jax():
    body = ("from benchmark.core import harness\n"
            "harness.run('SimGCL-yelp2018.eval', 3, 0.0, True, 'cpu', time.perf_counter(),\n"
            "            overrides={'users': 200, 'items': 300, 'interactions': 3000})\n"
            "harness.run('SASRec-amazon-beauty.train', 3, 0.0, False, 'cpu', time.perf_counter(),\n"
            "            overrides={'sequences': 300, 'items': 200, 'batch.size': 32,\n"
            "                       'max.len': 12})\n")
    tops = _tops(body)
    assert "selfrec_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_harness_names_what_it_finds(monkeypatch):
    from benchmark.core import harness

    monkeypatch.setitem(sys.modules, "selfrec_tpu.models", type(sys)("selfrec_tpu.models"))
    assert harness.forbidden_modules() == ["selfrec_tpu"]
