"""The port never imports JAX (or Flax/Optax/Orbax) nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "guitar_tablature_classification_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "guitar_tablature_classification_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize(
    "path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_imports_no_jax(path):
    """Every import statement, and every importlib/__import__ call with a
    literal name, in the port and chip_smoke.py."""
    tree = ast.parse(open(path).read(), path)
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            named.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            named.append(node.args[0].value)
    bad = [m for m in named if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_runs_without_jax_in_sys_modules(tmp_path):
    """Import the port, its tools (the runbook's too), its train CLI and
    bench, the dataset path's modules (loaders, pipeline, extractor,
    extraction, report plots with Matplotlib), the parallel package,
    streaming, the tab image and the librosa oracle, build a Transcriber
    and the CLI on the CPU, run one short transcription and one stream,
    plan a mesh, then check sys.modules."""
    script = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
import guitar_tablature_classification_tpu_torch
from guitar_tablature_classification_tpu_torch.config import RECIPES
from guitar_tablature_classification_tpu_torch.infer import Transcriber, cli
from guitar_tablature_classification_tpu_torch.models import convert
from guitar_tablature_classification_tpu_torch.ops import conv3x3, cqt_cuda, stem_tail
from guitar_tablature_classification_tpu_torch.tools import probe_conv, profile_stem_pieces
from guitar_tablature_classification_tpu_torch import bench, data, labels, utils
from guitar_tablature_classification_tpu_torch.ops import augment
from guitar_tablature_classification_tpu_torch.train import checkpoint, metrics, run
from guitar_tablature_classification_tpu_torch import report
from guitar_tablature_classification_tpu_torch.data import audio_loader, native_loader, pipeline
from guitar_tablature_classification_tpu_torch.labels import extractor
from guitar_tablature_classification_tpu_torch.models import small_cnn
from guitar_tablature_classification_tpu_torch.ops import extract
from guitar_tablature_classification_tpu_torch.tools import make_synthetic_guitarset, run_guitarset
from guitar_tablature_classification_tpu_torch import parallel
from guitar_tablature_classification_tpu_torch.parallel import collectives, mesh
from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber, streaming, tab_image
from guitar_tablature_classification_tpu_torch.ops import cqt_librosa, min_max_normalize
report.plots._plt()
run.make_config(run.build_parser().parse_args(["--synthetic", "--recipe", "native-best"]))
cfg = RECIPES["native-best"]()
t = Transcriber(None, model_cfg=cfg.model, cqt_cfg=cfg.cqt, batch_size=4,
                device="cpu")
out = t.transcribe(np.zeros(cfg.cqt.window_samples * 2, np.float32))
assert out.frets.shape == (3, 6)
s = StreamingTranscriber(t)
s.feed(np.zeros(cfg.cqt.window_samples * 2, np.float32))
assert s.flush().frets.shape[1] == 6
assert parallel.make_mesh(world_size=2, rank=1, device="cpu").shape == {{"data": 2, "model": 1}}
args = cli.build_parser().parse_args(["x.wav", "--recipe", "native-best",
                                      "--device", "cpu"])
cli.load_transcriber(args)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
print("FORBIDDEN", bad)
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
