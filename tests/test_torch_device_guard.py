"""Every kernel wrapper launches under a device guard (CPU, no card): the
launch goes through ``_build.launch``, which makes the input tensors'
device current (``torch.cuda.device``) and passes that device's current
stream, whatever card the caller has current. The launch helper runs here
with ``torch.cuda.device`` / ``torch.cuda.current_stream`` patched; the
wrappers' launch sites are read from their source (their CUDA branch needs
a card)."""
import ast
import contextlib
from pathlib import Path

import pytest
import torch

from audio_classification_tpu_torch import _build

KERNELS = Path(__file__).resolve().parents[1] / "audio_classification_tpu_torch" / "ops" / "kernels"
# wrapper module -> (the tensor whose device a launch takes, launches in the file)
LAUNCHERS = {"attention.py": ("q", 2), "gau.py": ("q", 1), "tcn.py": ("x", 1),
             "fbank.py": ("frames", 1)}


def test_launch_enters_the_device_and_passes_its_stream(monkeypatch):
    entered, asked = [], []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    class Stream:
        def __init__(self, d):
            asked.append(d)
            self.cuda_stream = 7000 + (d.index or 0)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    calls = []
    dev = torch.device("cuda", 1)
    _build.launch("act_x", lambda *a: calls.append(a) or 0, dev, 11, 22)
    assert entered == [dev] and asked == [dev] and calls == [(11, 22, 7001)]
    with pytest.raises(RuntimeError, match="act_y failed to launch: cudaError 3"):
        _build.launch("act_y", lambda *a: 3, dev)


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_every_wrapper_launches_through_the_guard(name):
    """No launch takes a stream of its own: each kernel entry is called by
    ``_build.launch(<name>, fn, <input>.device, ...)``."""
    src = (KERNELS / name).read_text()
    assert "current_stream" not in src and "_build.check" not in src
    tensor, n = LAUNCHERS[name]
    launches = [node for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"]
    assert len(launches) == n
    for call in launches:
        dev = call.args[2]
        assert isinstance(dev, ast.Attribute) and dev.attr == "device"
        assert getattr(dev.value, "id", None) == tensor, ast.unparse(call)
