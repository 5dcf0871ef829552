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


@pytest.mark.parametrize("path", ["kubernetes_tpu_torch", "chip_smoke.py", "scripts/torch_drain_profile.py",
                                  "scripts/topology_ab.py"])
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


# the reference Scheduler's keywords and methods the port has no counterpart
# for: ("ok", kwargs) constructs; ("refused", kwargs or a method name, the
# text the NotImplementedError must hold)
_ITEM4, _ITEM6, _ITEM8 = "queue 1 item 4", "queue 1 item 6", "queue 1 item 8"
_REFERENCE_SURFACE = [
    ("ok", dict(speculate=False)), ("ok", dict(spec_depth=2)), ("ok", dict(compile_plan=None)),
    ("ok", dict(columnar_cache=False)), ("ok", dict(error_fn=None)), ("ok", dict(event_fn=None)),
    ("ok", dict(trace=None)), ("ok", dict(trace=False)), ("ok", dict(fault_plan=None)),
    ("ok", dict(bind_workers=8)), ("ok", dict(fold_plane=True)), ("ok", dict(commit_plane=False, fold_plane=False)),
    ("ok", dict(speculate=False, spec_depth=2, compile_plan=None, columnar_cache=False, error_fn=None,
                event_fn=None, trace=None, fault_plan=None, bind_workers=8, commit_plane=True, fold_plane=True)),
    ("refused", dict(speculate=True), _ITEM6), ("refused", dict(spec_depth=3), _ITEM6),
    ("refused", dict(compile_plan=object()), _ITEM6), ("refused", dict(columnar_cache=True), _ITEM4),
    ("refused", dict(error_fn=print), _ITEM8), ("refused", dict(event_fn=print), _ITEM8),
    ("refused", dict(trace=True), _ITEM8), ("refused", dict(fault_plan=object()), _ITEM8),
    ("refused", dict(bind_workers=4), _ITEM8), ("refused", dict(bind_workers=True), _ITEM8),
    ("refused", dict(commit_plane=True, fold_plane=False), "fold_plane=False"),
    ("refused", dict(commit_plane=False, fold_plane=True), "fold_plane=True"),
    ("refused", "warmup", _ITEM6), ("refused", "ready", _ITEM6), ("refused", "flush_speculative", _ITEM6),
    ("refused", "abort", _ITEM8), ("refused", "dump_trace", _ITEM8),
    ("refused", "enable_health_monitor", _ITEM8), ("refused", "service_faults", _ITEM8),
]


def _surface_id(case) -> str:
    """A stable test id (no object addresses: every worker collects the same)."""
    what = case[1]
    if isinstance(what, str):
        return f"{case[0]}-{what}"
    return case[0] + "-" + ",".join(
        f"{k}={v!r}" if v is None or isinstance(v, (bool, int)) else f"{k}=<{type(v).__name__}>"
        for k, v in what.items())


@pytest.mark.parametrize("case", _REFERENCE_SURFACE, ids=_surface_id)
def test_reference_scheduler_surface_is_accepted_or_refused(case):
    """Each reference keyword the port's behaviour equals constructs; any
    other value, and each reference-only method, raises
    NotImplementedError naming its ROADMAP item (never TypeError or
    AttributeError); commit_plane without fold_plane is refused by name."""
    if case[0] == "ok":
        sched = Scheduler(device="cpu", **case[1])
        assert sched.device.type == "cpu"
        sched.close()
        return
    _, what, text = case
    if isinstance(what, dict):
        with pytest.raises(NotImplementedError, match=text):
            Scheduler(device="cpu", **what)
        return
    sched = Scheduler(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match=text):
            attr = getattr(sched, what)
            attr("trace.json") if what == "dump_trace" else attr()
    finally:
        sched.close()


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


def _struct_mirrors():
    """Every ctypes mirror of a kernel's argument struct in the port, as
    (class, C struct name, source file) from its docstring."""
    import ctypes
    import importlib
    import re

    out = []
    for name in _modules():
        mod = importlib.import_module(name)
        for cls in vars(mod).values():
            if isinstance(cls, type) and issubclass(cls, ctypes.Structure) and cls.__module__ == name:
                m = re.search(r"`struct (\w+)` in (csrc/\w+\.cu)", cls.__doc__ or "")
                assert m, f"{name}.{cls.__name__} names no C struct"
                out.append((cls, m.group(1), m.group(2)))
    return out


_C_WIDTHS = {"int32_t": 4, "uint32_t": 4, "int64_t": 8, "uint64_t": 8, "uint8_t": 1, "int": 4}


def test_ctypes_mirrors_cover_the_redesigned_structs():
    """The victim search's and the score matrix's argument structs (their
    walk state, step facts, counters and launch split) are among the
    mirrors the check below holds against the C structs."""
    names = {cname: {f[0] for f in cls._fields_} for cls, cname, _ in _struct_mirrors()}
    assert {"state", "step_flags", "step_checked", "walk_stats", "NP", "resident",
            "victims_resident"} <= names["PreemptArgs"]
    assert {"raw", "C", "TPC", "raw_shared", "smem"} <= names["ScoreArgs"]


def test_ctypes_mirrors_cover_the_spread_filter_and_mask_structs():
    """The spread filter's one-launch struct (the term fields its in-launch
    matching reads, the tables it writes, its cluster layout) and the mask's
    tile fields are among the mirrors the check below holds against the C
    structs; the spread score's struct keeps only its soft-term fields."""
    names = {cname: {f[0] for f in cls._fields_} for cls, cname, _ in _struct_mirrors()}
    assert {"t_has_selector", "t_ml_slot", "t_ns_ids", "e_labels", "e_ns", "cand", "merged_cnt", "min_t",
            "any_pair_t", "C", "slice", "vslice", "copies", "local_table", "smem"} <= names["SpreadFilterArgs"]
    assert {"counts64", "UT", "NT", "row_bytes", "staged", "smem"} <= names["FilterArgs"]
    assert not {"mask", "min_t", "kind", "t_weight"} & names["SpreadArgs"]


def test_ctypes_mirrors_cover_the_spread_score_and_match_structs():
    """The spread score's one-launch struct (the term fields its in-launch
    matching reads, its cluster layout, its device-memory tables) and the
    multi-problem match struct (with its port slice's problem) are among
    the mirrors the check below holds against the C structs."""
    names = {cname: {f[0] for f in cls._fields_} for cls, cname, _ in _struct_mirrors()}
    assert {"t_has_selector", "t_ml_slot", "t_ex_vals", "e_labels", "merged_cnt", "merged_present", "R", "C",
            "slice", "vslice", "copies", "dense_cap", "smem"} <= names["SpreadArgs"]
    assert not {"m_sig", "member", "sig_list", "pair_cnt", "table_in_shared"} & names["SpreadArgs"]
    assert names["MatchArgs"] == {"p", "port", "count", "smem"} and "xtile" in names["MatchProblem"]
    assert names["PortProblem"] == {"num", "proto", "ip", "out", "U", "PP", "wildcard_ip", "rows", "cols"}


def test_ctypes_mirrors_cover_the_interpod_filter_and_selector_spread_structs():
    """The inter-pod filter's one-launch struct (its cluster layout and
    device-memory tables, no scratch of the tables it keeps in shared
    memory) and the selector spread's (its cluster layout and zone-table
    mode, no signature-list scratch) are among the mirrors the check below
    holds against the C structs; the inter-pod score's struct (its own
    cluster layout) has none of the filter's mask fields."""
    names = {cname: {f[0] for f in cls._fields_} for cls, cname, _ in _struct_mirrors()}
    assert {"m_pt", "m_sig", "self_aff_match", "has_aff", "dtable", "mask", "C", "slice", "vslice", "tcap",
            "smem"} <= names["InterpodFilterArgs"]
    assert not {"sig_list", "x_table", "t_table", "any_pair", "table_in_shared"} & names["InterpodFilterArgs"]
    assert {"ztable", "C", "slice", "vslice", "mode", "smem"} <= names["SelSpreadArgs"]
    assert not {"sig_list", "table_in_shared"} & names["SelSpreadArgs"]
    assert not {"mask", "has_aff", "self_aff_match", "any_pair"} & names["InterpodArgs"]


@pytest.mark.parametrize("mirror", _struct_mirrors(), ids=lambda m: m[1])
def test_ctypes_mirror_matches_the_kernel_struct(mirror):
    """A wrapper's ctypes struct has the C struct's fields in the same
    order at the same widths (a drift is read wrongly only on the card)."""
    import ctypes
    import re

    cls, cname, src = mirror
    with open(os.path.join(PKG, src)) as f:
        text = f.read()
    m = re.search(r"struct (?:__align__\(\d+\) )?%s \{(.*?)\n\};" % cname, text, re.S)
    assert m, f"no struct {cname} in {src}"
    fields = []
    for decl in re.sub(r"//[^\n]*", "", m.group(1)).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        t = re.match(r"(?:const\s+)?([\w:]+)\s*(\**)\s*(.*)", decl, re.S)
        ctype, ptr, rest = t.groups()
        for part in rest.split(","):
            arr = re.search(r"\[(\w+)\]", part)
            fields.append((part.strip().lstrip("*").split("[")[0].strip().rstrip("_"),
                           "*" if ptr or part.strip().startswith("*") else ctype, arr.group(1) if arr else None))
    py = cls._fields_
    assert [f[0] for f in fields] == [f[0].rstrip("_") for f in py]  # `free` may be spelt free_
    for (name, ctype, arr), (_, pytype) in zip(fields, py):
        if ctype == "*":
            assert ctypes.sizeof(pytype) == 8, name
        elif ctype in _C_WIDTHS:
            assert ctypes.sizeof(pytype) == _C_WIDTHS[ctype] * (1 if arr is None else pytype._length_), name
        else:  # a nested struct or an array of them
            inner = pytype._type_ if arr else pytype
            assert inner.__name__ == ctype, name
