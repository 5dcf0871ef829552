"""The port package stands alone: it imports without jax or kubernetes_tpu,
imports neither anywhere in its source (nor do chip_smoke.py and
scripts/torch_drain_profile.py), and its entry points refuse to fall back
to the CPU silently."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.scheduler.driver import Scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kubernetes_tpu_torch")


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "kubernetes_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="kubernetes_tpu_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "kubernetes_tpu_torch.scheduler.driver" in mods and "kubernetes_tpu_torch.kernels.build" in mods
    assert "kubernetes_tpu_torch.commit.apply" in mods  # the gang commit's rollback record
    # the Policy config, the framework and the HTTP extender
    for m in ("config", "config.factory", "config.policy", "framework.interface", "framework.plugins.builtin",
              "extender.server", "extender.client", "extender.types", "utils.featuregate"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m
    # the ingest and term planes and their slab kernels' wrappers
    for m in ("ingest", "ingest.stage", "ingest.gather", "ingest.bank", "terms_plane", "terms_plane.stage",
              "terms_plane.gather", "terms_plane.bank", "ops.slab"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'kubernetes_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import importlib
for m in {mods!r}:
    importlib.import_module(m)
assert not any(k.split('.')[0] in ('jax', 'kubernetes_tpu') for k in sys.modules), 'leak'
print('ok', len({mods!r}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", ["kubernetes_tpu_torch", "chip_smoke.py", "scripts/torch_drain_profile.py"])
def test_source_names_no_jax_or_reference_import(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")
    ]
    assert files
    bad = []
    for f in files:
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(f, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((f, node.module))
    assert not bad, bad


def test_scheduler_without_cuda_raises(monkeypatch):
    """The Scheduler, the extender server and the Configurator run on the
    card unless asked for the CPU; without a card they raise."""
    from kubernetes_tpu_torch.config import Configurator
    from kubernetes_tpu_torch.extender import ExtenderServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler()
    with pytest.raises(RuntimeError):
        Scheduler(device="cuda")
    assert Scheduler(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExtenderServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Configurator()
    with pytest.raises(RuntimeError):
        Configurator(device="cuda")
    srv = ExtenderServer(device="cpu")
    assert srv.device.type == "cpu"
    srv.stop()
    assert Configurator(device="cpu").create_from_provider().device.type == "cpu"


def test_kernel_wrapper_refuses_other_devices():
    meta = {k: torch.empty(3, device="meta") for k in ("valid", "fallback")}
    with pytest.raises(ValueError, match="no filter kernel"):
        F.combined_mask(meta, meta, {})


def test_entry_points_match_the_kernel_sources():
    """The library resolves exactly the C entry points the CUDA sources
    define (a name left behind fails only when the card loads it)."""
    import glob
    import re

    from kubernetes_tpu_torch.kernels import build

    defined = set()
    for src in glob.glob(os.path.join(PKG, "csrc", "*.cu")):
        with open(src) as f:
            defined |= set(re.findall(r'extern "C" int (ktpu_\w+)\(', f.read()))
    assert len(build.ENTRY_POINTS) == len(set(build.ENTRY_POINTS))
    assert set(build.ENTRY_POINTS) == defined
