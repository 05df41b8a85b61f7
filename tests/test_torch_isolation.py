"""The port stands alone: importing every module of versecrafter_tpu_torch
and chip_smoke.py's imports loads no JAX and nothing of the JAX package,
and the port's config dataclasses copy the JAX ones field for field."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

from versecrafter_tpu.core import config as jconfig
from versecrafter_tpu_torch.core import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "versecrafter_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "versecrafter_tpu"
            or name.startswith("versecrafter_tpu."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import versecrafter_tpu_torch\n"
        "for m in pkgutil.walk_packages(versecrafter_tpu_torch.__path__,"
        " 'versecrafter_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "versecrafter_tpu_torch.sampling.pipeline" in loaded
    assert "chip_smoke" in loaded
    assert [n for n in loaded if _forbidden(n)] == []


# absent from the GPU machine's installation
CARD_MISSING = ("cv2", "safetensors", "transformers")


def test_the_port_imports_without_cv2_safetensors_transformers():
    """Every module of the port and chip_smoke.py import with OpenCV,
    safetensors and transformers blocked, as on the GPU machine."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.modules.update(dict.fromkeys({CARD_MISSING!r}))\n"
        "import versecrafter_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(versecrafter_tpu_torch.__path__,"
        " 'versecrafter_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    for name in ("core.convert", "core.checkpoint", "serve.api_server", "serve.http",
                 "serve.tasks", "utils.video", "utils.profiling", "cli.inference",
                 "geometry.pointcloud", "geometry.gaussians", "geometry.render",
                 "cli.render_maps", "cli.fit_gaussian"):
        assert f"versecrafter_tpu_torch.{name}" in names


@pytest.mark.parametrize("path", _sources())
def test_no_source_imports_jax(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize("name", ["WanDiTConfig", "VAEConfig", "T5Config",
                                  "SchedulerConfig", "PipelineConfig"])
def test_config_fields_match_jax(name):
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(getattr(tconfig, name)) == spec(getattr(jconfig, name))


def test_named_configs_match_jax():
    for name in ("WAN21_1_3B", "WAN21_14B"):
        assert (dataclasses.asdict(getattr(tconfig, name))
                == dataclasses.asdict(getattr(jconfig, name)))
    assert (dataclasses.asdict(tconfig.versecrafter_14b())
            == dataclasses.asdict(jconfig.versecrafter_14b()))
    cfg = tconfig.versecrafter_14b()
    assert cfg.resolved_geoada_layers == jconfig.versecrafter_14b().resolved_geoada_layers
    assert cfg.head_dim == 128
