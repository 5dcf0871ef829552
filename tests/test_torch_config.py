"""The port's config surface against the reference's: feature gates,
algorithm providers, the Policy parser (valid and invalid documents: RTCR
shapes, negative weights, a second RTCR entry, extended resources,
custom-argument entries, extenders) and the ComponentConfig parser, field
for field; every scenario of tests/test_config.py built by both
Configurators (the cluster's cache handed to the Scheduler) with equal
assignments; and seeded random clusters drained under three
RequestedToCapacityRatio Policies (the default shape, bin-packing, a
down-sloping five-point shape over cpu 3 / memory 1) pod for pod against
the reference Scheduler with the same planes (`speculate=False,
columnar_cache=False`; the port on the CPU). Exact equality throughout."""

import dataclasses
import json

import pytest

import kubernetes_tpu.ops  # noqa: F401  (turns x64 on, as the reference runs)
from kubernetes_tpu import config as RC
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.utils import featuregate as RFG

from kubernetes_tpu_torch import config as PC
from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import fill_cache, make_node, make_pod, policy_cluster, random_cluster
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.utils import featuregate as PFG

PKGS = {
    "ref": dict(t=RT, C=RC, FG=RFG, Cache=RCache, kw=dict(speculate=False, columnar_cache=False)),
    "port": dict(t=PT, C=PC, FG=PFG, Cache=SchedulerCache, kw=dict(device="cpu")),
}


def policy_from_reference(obj):
    """The same Policy document through both parsers → the two Policies as
    comparable plain data (extender configs as dicts)."""
    out = {}
    for pkg, m in PKGS.items():
        pol = m["C"].parse_policy(json.loads(json.dumps(obj)))
        d = {f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)}
        d["extenders"] = [dataclasses.asdict(e) for e in pol.extenders]
        out[pkg] = d
    assert out["port"] == out["ref"]
    return out["port"]


def test_feature_gates():
    got = {}
    for pkg, m in PKGS.items():
        fg = m["FG"].FeatureGate()
        row = [fg.enabled(n) for n in sorted(fg.known())]
        fg.parse("EvenPodsSpread=true,ResourceLimits=false")
        row.append((fg.enabled("EvenPodsSpread"), fg.enabled("ResourceLimits")))
        errs = []
        for bad in ("NoSuchGate=true", "TaintNodesByCondition=false", "EvenPodsSpread", "EvenPodsSpread=maybe"):
            try:
                fg.parse(bad)
                errs.append(None)
            except (KeyError, ValueError) as e:
                errs.append(type(e).__name__)
        got[pkg] = (sorted(fg.known()), row, errs, m["FG"].DEFAULT_FEATURE_GATE.enabled("EvenPodsSpread"))
    assert got["port"] == got["ref"]
    assert got["port"][2] == ["KeyError", "ValueError", "ValueError", "ValueError"]


@pytest.mark.parametrize("gates", ["", "EvenPodsSpread=true", "ResourceLimits=true",
                                   "EvenPodsSpread=true,ResourceLimits=true"])
def test_providers(gates):
    got = {}
    for pkg, m in PKGS.items():
        fg = m["FG"].FeatureGate()
        fg.parse(gates)
        got[pkg] = (m["C"].default_predicates(fg), m["C"].default_priorities(fg),
                    m["C"].get_provider("ClusterAutoscalerProvider", fg), sorted(m["C"].PROVIDERS),
                    m["C"].KNOWN_PREDICATES, m["C"].KNOWN_PRIORITIES, m["C"].VOLUME_PREDICATES)
    assert got["port"] == got["ref"]


RTCR_SHAPES = {
    "default": None,
    "binpack": [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}],
    "down": [{"utilization": 0, "score": 2}, {"utilization": 20, "score": 9}, {"utilization": 45, "score": 1},
             {"utilization": 80, "score": 6}, {"utilization": 100, "score": 0}],
}


def rtcr_policy(shape_name, resources=None):
    """The chip-smoke RTCR Policy: GeneralPredicates, PodToleratesNodeTaints,
    CheckNodeUnschedulable, MatchInterPodAffinity; RTCR at weight 2 (the
    named shape, or the kernel's default without arguments), NodeAffinity
    and TaintToleration at 1."""
    if RTCR_SHAPES[shape_name] is None:
        rtcr = {"name": "RequestedToCapacityRatioPriority", "weight": 2}
    else:
        args = {"shape": RTCR_SHAPES[shape_name]}
        if resources is not None:
            args["resources"] = resources
        rtcr = {"name": "BinPack", "weight": 2, "argument": {"requestedToCapacityRatioArguments": args}}
    return {
        "kind": "Policy",
        "predicates": [{"name": n} for n in ("GeneralPredicates", "PodToleratesNodeTaints", "CheckNodeUnschedulable",
                                             "MatchInterPodAffinity")],
        "priorities": [rtcr, {"name": "NodeAffinityPriority", "weight": 1},
                       {"name": "TaintTolerationPriority", "weight": 1}],
    }


VALID = {
    "full": {
        "kind": "Policy",
        "predicates": [{"name": "PodFitsResources"}, {"name": "PodToleratesNodeTaints"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 2}],
        "extenders": [{"urlPrefix": "http://x:1", "filterVerb": "filter", "nodeCacheCapable": True, "weight": 3,
                       "managedResources": [{"name": "example.com/gpu"}], "ignorable": True, "httpTimeout": 2}],
        "hardPodAffinitySymmetricWeight": 10,
    },
    "absent": {},
    "empty-lists": {"predicates": [], "priorities": []},
    "rtcr-binpack": rtcr_policy("binpack"),
    "rtcr-down": rtcr_policy("down", [{"name": "cpu", "weight": 3}, {"name": "memory"}]),
    "rtcr-default": rtcr_policy("default"),
    "custom": {
        "predicates": [{"name": "GeneralPredicates"},
                       {"name": "NoRetiring", "argument": {"labelsPresence": {"labels": ["retiring"], "presence": False}}},
                       {"name": "SvcRegion", "argument": {"serviceAffinity": {"labels": ["region"]}}}],
        "priorities": [{"name": "PreferSSD", "weight": 5,
                        "argument": {"labelPreference": {"label": "disktype", "presence": True}}},
                       {"name": "SvcSpread", "weight": 10, "argument": {"serviceAntiAffinity": {"label": "zone"}}}],
    },
}

_SHAPE = [{"utilization": 0, "score": 10}, {"utilization": 100, "score": 0}]
INVALID = {
    "kind": {"kind": "ConfigMap"},
    "unknown-predicate": {"predicates": [{"name": "NotAPredicate"}]},
    "unknown-priority": {"priorities": [{"name": "NotAPriority"}]},
    "negative-weight": {"priorities": [{"name": "LeastRequestedPriority", "weight": -1}]},
    "rtcr-unsorted": {"priorities": [{"name": "x", "argument": {"requestedToCapacityRatioArguments": {
        "shape": [{"utilization": 50, "score": 1}, {"utilization": 50, "score": 2}]}}}]},
    "rtcr-score-range": {"priorities": [{"name": "x", "argument": {"requestedToCapacityRatioArguments": {
        "shape": [{"utilization": 0, "score": 11}]}}}]},
    "rtcr-empty-shape": {"priorities": [{"name": "x", "argument": {"requestedToCapacityRatioArguments": {
        "shape": []}}}]},
    "rtcr-negative-resource": {"priorities": [{"name": "x", "argument": {"requestedToCapacityRatioArguments": {
        "shape": _SHAPE, "resources": [{"name": "cpu", "weight": -2}]}}}]},
    "rtcr-duplicate": {"priorities": [
        {"name": "a", "argument": {"requestedToCapacityRatioArguments": {"shape": _SHAPE}}},
        {"name": "b", "argument": {"requestedToCapacityRatioArguments": {"shape": _SHAPE}}}]},
    "rtcr-extended": {"priorities": [{"name": "x", "argument": {"requestedToCapacityRatioArguments": {
        "shape": [{"utilization": 0, "score": 10}], "resources": [{"name": "nvidia.com/gpu", "weight": 1}]}}}]},
    "hard-weight": {"hardPodAffinitySymmetricWeight": 101},
}


@pytest.mark.parametrize("name", list(VALID))
def test_parse_policy_matches_reference(name):
    pol = policy_from_reference(VALID[name])
    if name.startswith("rtcr-") and name != "rtcr-default":
        assert pol["rtcr"] is not None and ("RequestedToCapacityRatioPriority", 2) in pol["priorities"]


@pytest.mark.parametrize("name", list(INVALID))
def test_parse_policy_rejects_as_reference(name):
    for pkg, m in PKGS.items():
        with pytest.raises(m["C"].PolicyError):
            m["C"].parse_policy(json.loads(json.dumps(INVALID[name])))


def test_component_config_matches_reference():
    doc = {
        "schedulerName": "tpu-scheduler",
        "algorithmSource": {"policy": {"file": {"path": "/etc/p.json"}}},
        "bindTimeoutSeconds": 30,
        "percentageOfNodesToScore": 70,
        "leaderElection": {"leaderElect": True, "leaseDuration": "1m30s", "renewDeadline": "10s",
                           "retryPeriod": 2},
        "featureGates": {"EvenPodsSpread": True},
    }
    got = {}
    for pkg, m in PKGS.items():
        for d in (doc, {}, {"algorithmSource": {"provider": "ClusterAutoscalerProvider"}}):
            got.setdefault(pkg, []).append(dataclasses.asdict(m["C"].parse_component_config(d)))
    assert got["port"] == got["ref"]
    assert got["port"][0]["leader_election"]["lease_duration_s"] == 90.0


# --- tests/test_config.py's scenarios through both Configurators -------------

def _sched(pkg, cache, policy=None, provider=None, **cfg_kw):
    m = PKGS[pkg]
    cfgr = m["C"].Configurator(deterministic=True, cache=cache, enable_preemption=False, **m["kw"], **cfg_kw)
    if provider is not None:
        return cfgr.create_from_provider(provider)
    return cfgr.create_from_config(policy)


def _run(build_cache, pods_fn, policy=None, provider=None, **cfg_kw):
    """Build, enqueue and run one batch in each package; the assignments
    and counts must be equal."""
    out = {}
    for pkg, m in PKGS.items():
        cache = m["Cache"]()
        build_cache(m["t"], cache)
        extra = {k: (v(m["t"]) if callable(v) else v) for k, v in cfg_kw.items()}
        sched = _sched(pkg, cache, policy, provider, **extra)
        for p in pods_fn(m["t"]):
            sched.queue.add(p)
        res = sched.schedule_batch()
        out[pkg] = (res.scheduled, res.unschedulable, dict(res.assignments))
    assert out["port"] == out["ref"]
    return out["port"]


def test_policy_disabling_taints_changes_scheduling():
    def cache_fn(t, cache):
        cache.add_node(make_node("tainted", cpu_milli=4000, mem=8 * 2**30,
                                 taints=[t.Taint(key="dedicated", value="x", effect="NoSchedule")], t=t))

    pods = lambda t: [make_pod("p0", cpu_milli=100, mem=0, t=t)]  # noqa: E731
    assert _run(cache_fn, pods, provider="DefaultProvider")[:2] == (0, 1)
    assert _run(cache_fn, pods, policy={"predicates": [{"name": "GeneralPredicates"}],
                                        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]})[0] == 1


def _packed(t, cache):
    for name in ("packed", "empty"):
        cache.add_node(make_node(name, cpu_milli=4000, mem=8 * 2**30, t=t))
    cache.add_pod(make_pod("filler", cpu_milli=3000, mem=0, node_name="packed", t=t))


@pytest.mark.parametrize("prio,want", [("LeastRequestedPriority", "empty"), ("MostRequestedPriority", "packed")])
def test_policy_priority_weights_change_selection(prio, want):
    _, _, assign = _run(_packed, lambda t: [make_pod("a", cpu_milli=100, mem=0, t=t)],
                        policy={"predicates": [{"name": "GeneralPredicates"}],
                                "priorities": [{"name": prio, "weight": 1}]})
    assert assign["default/a"] == want


def test_policy_rtcr_bin_packing_changes_selection():
    policy = {"predicates": [{"name": "GeneralPredicates"}],
              "priorities": [{"name": "RequestedToCapacityRatio", "weight": 1,
                              "argument": {"requestedToCapacityRatioArguments": {"shape": RTCR_SHAPES["binpack"]}}}]}
    _, _, assign = _run(_packed, lambda t: [make_pod("c", cpu_milli=100, mem=0, t=t)], policy=policy)
    assert assign["default/c"] == "packed"


def test_resource_limits_feature_gate_registration():
    for pkg, m in PKGS.items():
        fg = m["FG"].FeatureGate()
        assert not any(n == "ResourceLimitsPriority" for n, _ in m["C"].default_priorities(fg))
        fg.parse("ResourceLimits=true")
        assert ("ResourceLimitsPriority", 1) in m["C"].default_priorities(fg)


def test_policy_labels_presence_predicate():
    def cache_fn(t, cache):
        cache.add_node(make_node("retiring", labels={"retiring": "2026-01-01"}, t=t))
        cache.add_node(make_node("healthy", t=t))

    _, _, assign = _run(cache_fn, lambda t: [make_pod("p", cpu_milli=100, mem=0, t=t)], policy={
        "predicates": [{"name": "GeneralPredicates"},
                       {"name": "NoRetiringNodes",
                        "argument": {"labelsPresence": {"labels": ["retiring"], "presence": False}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]})
    assert assign["default/p"] == "healthy"


def test_policy_label_preference_priority():
    def cache_fn(t, cache):
        cache.add_node(make_node("plain", t=t))
        cache.add_node(make_node("ssd", labels={"disktype": "ssd"}, t=t))

    _, _, assign = _run(cache_fn, lambda t: [make_pod("p", cpu_milli=100, mem=0, t=t)], policy={
        "predicates": [{"name": "GeneralPredicates"}],
        "priorities": [{"name": "PreferSSD", "weight": 5,
                        "argument": {"labelPreference": {"label": "disktype", "presence": True}}}]})
    assert assign["default/p"] == "ssd"


def test_policy_service_affinity_and_anti_affinity():
    def cache_fn(t, cache):
        for name, region, zone in (("r1a", "r1", "a"), ("r1b", "r1", "b"), ("r2a", "r2", "a")):
            cache.add_node(make_node(name, labels={"region": region, "zone": zone}, t=t))
        cache.add_pod(make_pod("w0", labels={"app": "web"}, cpu_milli=100, mem=0, node_name="r1a", t=t))

    services = lambda t: (lambda: [t.Service(name="svc", namespace="default", selector={"app": "web"})])  # noqa: E731
    _, _, assign = _run(cache_fn, lambda t: [make_pod("w1", labels={"app": "web"}, cpu_milli=100, mem=0, t=t)],
                        policy={"predicates": [{"name": "GeneralPredicates"},
                                               {"name": "SvcRegion",
                                                "argument": {"serviceAffinity": {"labels": ["region"]}}}],
                                "priorities": [{"name": "SvcSpread", "weight": 10,
                                                "argument": {"serviceAntiAffinity": {"label": "zone"}}}]},
                        service_lister=services)
    assert assign["default/w1"] == "r1b"


def test_component_config_with_policy_file(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(rtcr_policy("binpack")))
    out = {}
    for pkg, m in PKGS.items():
        cache = m["Cache"]()
        _packed(m["t"], cache)
        cc = m["C"].parse_component_config({"algorithmSource": {"policy": {"file": {"path": str(path)}}},
                                            "featureGates": {"EvenPodsSpread": True}})
        cfgr = m["C"].Configurator(deterministic=True, cache=cache, **m["kw"])
        sched = cfgr.create_from_component_config(cc)
        sched.queue.add(make_pod("c", cpu_milli=100, mem=0, t=m["t"]))
        res = sched.schedule_batch()
        out[pkg] = (dict(res.assignments), sched.solve_config.rtcr, cfgr.feature_gates.enabled("EvenPodsSpread"))
    assert out["port"] == out["ref"] and out["port"][0] == {"default/c": "packed"}


def test_volume_seams_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        PC.Configurator(pvc_lister=lambda: [], pv_lister=lambda: [], device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        PC.Configurator(volume_binder=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Scheduler(volume_checker=lambda pod, ni: (True, []), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Scheduler(volume_binder=object(), device="cpu")


# --- seeded random-cluster drains under the RTCR Policies --------------------

@pytest.mark.parametrize("shape", list(RTCR_SHAPES))
@pytest.mark.parametrize("seed", [2, 7])
def test_rtcr_policy_drain_matches_reference(shape, seed):
    """A seeded random cluster (every predicate and priority branch, host
    ports, inter-pod terms) drained in batches of 16 under an RTCR Policy:
    the same placements batch for batch, and the same oracle counters."""
    resources = [{"name": "cpu", "weight": 3}, {"name": "memory"}] if shape == "down" else None
    policy = rtcr_policy(shape, resources)
    out = {}
    for pkg, m in PKGS.items():
        nodes, existing, pending = random_cluster(seed, 40, 60, 40, t=m["t"], pending_ports=True, topology=True,
                                                  interpod=True, pending_affinity=False)
        cache = m["Cache"]()
        fill_cache(cache, nodes, existing)
        sched = _sched(pkg, cache, policy, batch_size=16)
        for p in pending:
            sched.queue.add(p)
        batches = []
        for _ in range(8):
            r = sched.schedule_batch()
            batches.append((r.scheduled, r.unschedulable, sorted(r.assignments.items())))
            if not (r.scheduled or r.unschedulable):
                break
        st = sched.stats
        out[pkg] = (batches, st["oracle_rechecks"], st["oracle_places"], st["light_rechecks"])
    assert out["port"] == out["ref"]
    assert sum(b[0] for b in out["port"][0]) > 0


def test_custom_argument_policy_drain_matches_reference():
    """policy_cluster at a small size under the custom-argument Policy
    (labelsPresence, labelPreference, serviceAffinity, serviceAntiAffinity):
    every pod through `_oracle_place`'s full scan, the same placements."""
    policy = {
        "predicates": [{"name": "GeneralPredicates"}, {"name": "PodToleratesNodeTaints"},
                       {"name": "NoRetiring", "argument": {"labelsPresence": {"labels": ["retiring"],
                                                                              "presence": False}}},
                       {"name": "SvcRegion", "argument": {"serviceAffinity": {
                           "labels": ["failure-domain.beta.kubernetes.io/region"]}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                       {"name": "PreferSSD", "weight": 2,
                        "argument": {"labelPreference": {"label": "disktype", "presence": True}}},
                       {"name": "SvcSpread", "weight": 3, "argument": {"serviceAntiAffinity": {
                           "label": "failure-domain.beta.kubernetes.io/zone"}}}],
    }
    out = {}
    for pkg, m in PKGS.items():
        nodes, anchors, pods, services = policy_cluster(24, 60, n_apps=6, t=m["t"])
        cache = m["Cache"]()
        fill_cache(cache, nodes, anchors)
        sched = _sched(pkg, cache, policy, batch_size=32, service_lister=lambda s=services: s)
        for p in pods:
            sched.queue.add(p)
        res = sched.run_until_empty(max_cycles=10)
        out[pkg] = (res.scheduled, res.unschedulable, dict(res.assignments), sched.stats["oracle_places"])
    assert out["port"] == out["ref"]
    assert out["port"][0] == 60 and out["port"][3] == 60
    assert not any(a.endswith(("-0", "-7", "-14", "-21")) for a in out["port"][2].values())  # retiring nodes
