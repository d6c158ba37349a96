"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` begins with ``repro``), and
the plain reference imports nothing of the program."""

import subprocess
import sys
from pathlib import Path

from perfbench.harness.cell import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

EVERYTHING = """
import sys, importlib.util
from pathlib import Path
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import perfbench.harness.cell, perfbench.harness.system
import perfbench.traffic.closed_loop, perfbench.traffic.poisson
import perfbench.reference.decoder
for p in sorted(Path({root!r}, "perfbench", "metrics").glob("*.py")):
    s = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
# what a run builds: the serve entry, the engine, the kernels, the models
import repro_torch.launch.serve, repro_torch.serving, repro_torch.models
import repro_torch.kernels.compiled, repro_torch.kernels.q4_matmul
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import perfbench.reference.decoder, perfbench.reference.q4
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(out.stdout.split())


def test_run_imports_no_jax():
    names = top_level(EVERYTHING)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert "torch" in names
    assert not names & ({"repro_torch"} | set(FORBIDDEN))


def test_names_compared_whole():
    assert forbidden_modules(["repro_torch.serving", "jaxtyping",
                              "flaxen.x", "perfbench.harness"]) == []
    assert forbidden_modules(["repro.serving.engine", "jax.numpy",
                              "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
