"""Nothing the harness runs loads JAX or the JAX package, and the check that
every run makes compares whole top-level names (the port's name begins with
the JAX package's)."""
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import harness  # noqa: E402


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.run, perfbench.readings;"
            "from perfbench import harness, check, trace, traffic, weights, work;"
            "from perfbench.reference import models, pipeline, sensevoice;"
            "harness.load_family('sensevoice');"
            "import audio_classification_tpu_torch.pipelines.offline_overlap3;"
            "import audio_classification_tpu_torch.convert.torch_import;"
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    assert "audio_classification_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "audio_classification_tpu_torch_extra",
                        types.ModuleType("audio_classification_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "audio_classification_tpu.ops",
                        types.ModuleType("audio_classification_tpu.ops"))
    assert harness.forbidden_modules() == ["audio_classification_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "audio_classification_tpu" not in text and "import jax" not in text, path
