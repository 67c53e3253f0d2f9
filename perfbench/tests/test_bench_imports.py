"""The reference imports nothing of the program, and nothing the
benchmark loads is JAX or the JAX package (top-level names compared
whole)."""

import subprocess
import sys

from perfbench.harness.common import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded(body: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = loaded("import perfbench.reference.models.codd, "
                  "perfbench.harness.reference_model")
    assert "codd_torch" not in mods and "codd_tpu" not in mods


def test_harness_loads_no_jax():
    mods = loaded("import codd_torch.models.builder, "
                  "codd_torch.ops.kernels\n"
                  "from perfbench.harness import stream, trace, work, compare, control\n"
                  "import runpy; runpy.run_path('perfbench/run.py', run_name='probe')")
    assert not mods & {"jax", "jaxlib", "flax", "codd_tpu"}


def test_sources_name_no_forbidden_import():
    import re
    for path in (ROOT / "perfbench").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|codd_tpu)\b", text, re.M), path
        if "reference" in path.parts:
            assert not re.search(r"^\s*(import|from)\s+codd_torch\b", text, re.M), path
