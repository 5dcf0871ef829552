"""Configurator (pkg/scheduler/factory/factory.go:133): translate a
Provider name, Policy, or ComponentConfig into a configured Scheduler; the
port's copy of `kubernetes_tpu.config.factory`.

CreateFromProvider (:294) / CreateFromConfig (:304) / CreateFromKeys
(:382) semantics: the chosen predicate/priority sets become (a) a
SolveConfig gating the device kernels (the RequestedToCapacityRatio shape
rides into the score kernel's argument struct), (b) the oracle predicate
chain's enabled set (threaded via PredicateMetadata), (c) HTTPExtender
clients and (d) framework plugins for the Policy's custom-argument
predicates and priorities. The volume listers and binder raise: the port
has no volume seam yet (ROADMAP.md queue 1 item 7). The Scheduler runs on
the card unless `device="cpu"` is among the scheduler arguments; with no
card and no explicit CPU the Configurator raises.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Tuple

from ..device import resolve_device
from ..extender.client import ExtenderConfig, HTTPExtender
from ..framework.plugins.builtin import Handle, ServiceAffinityPlugin, predicate_plugin, priority_plugin
from ..ops.pipeline import SolveConfig
from ..oracle.predicates import check_node_label_presence
from ..oracle.priorities import node_label_priority, service_anti_affinity_priority
from ..scheduler.driver import Scheduler
from ..utils.featuregate import FeatureGate
from .componentconfig import KubeSchedulerConfiguration
from .policy import Policy, parse_policy
from .provider import default_predicates, default_priorities, get_provider


class Configurator:
    def __init__(
        self,
        feature_gates: Optional[FeatureGate] = None,
        pvc_lister: Optional[Callable] = None,
        pv_lister: Optional[Callable] = None,
        sc_lister: Optional[Callable] = None,
        csinode_lister: Optional[Callable] = None,
        volume_binder=None,
        service_lister: Optional[Callable] = None,
        **scheduler_kwargs,
    ):
        if any(x is not None for x in (pvc_lister, pv_lister, sc_lister, csinode_lister, volume_binder)):
            raise NotImplementedError(
                "Configurator(pvc_lister=..., pv_lister=..., volume_binder=...): volumes are not ported "
                "(ROADMAP.md queue 1 item 7, volumes)"
            )
        scheduler_kwargs["device"] = resolve_device(scheduler_kwargs.get("device"))
        self.feature_gates = feature_gates or FeatureGate()
        self.service_lister = service_lister
        self.scheduler_kwargs = scheduler_kwargs

    def create_from_provider(self, name: str = "DefaultProvider") -> Scheduler:
        predicates, priorities = get_provider(name, self.feature_gates)
        return self.create_from_keys(predicates, priorities, [])

    def create_from_config(self, policy) -> Scheduler:
        """policy: a Policy, a parsed JSON dict, or a JSON string."""
        if isinstance(policy, str):
            policy = json.loads(policy)
        if isinstance(policy, dict):
            policy = parse_policy(policy)
        if not isinstance(policy, Policy):
            raise TypeError(f"expected a Policy, a dict or a JSON string, got {type(policy).__name__}")
        return self.create_from_keys(
            policy.predicates,
            policy.priorities,
            policy.extenders,
            rtcr=policy.rtcr,
            custom_predicates=policy.custom_predicates,
            custom_priorities=policy.custom_priorities,
        )

    def create_from_component_config(self, cfg: KubeSchedulerConfiguration) -> Scheduler:
        if cfg.feature_gates:
            self.feature_gates.set_from_map(cfg.feature_gates)
        if cfg.policy_file:
            with open(cfg.policy_file) as f:
                return self.create_from_config(json.load(f))
        return self.create_from_provider(cfg.algorithm_provider or "DefaultProvider")

    def create_from_keys(
        self,
        predicates: Optional[frozenset],
        priorities: Optional[Tuple[Tuple[str, int], ...]],
        extender_configs: List[ExtenderConfig],
        rtcr=None,
        custom_predicates: Tuple[tuple, ...] = (),
        custom_priorities: Tuple[tuple, ...] = (),
    ) -> Scheduler:
        if predicates is None:
            predicates = default_predicates(self.feature_gates)
        if priorities is None:
            priorities = default_priorities(self.feature_gates)
        solve_config = SolveConfig(predicates=frozenset(predicates), priorities=tuple(priorities), rtcr=rtcr)
        sched = Scheduler(
            solve_config=solve_config,
            extenders=[HTTPExtender(c) for c in extender_configs],
            **self.scheduler_kwargs,
        )
        if custom_predicates or custom_priorities:
            # EXTEND the scheduler's framework (a caller-supplied one came
            # through scheduler_kwargs and already wired queue-sort): the
            # Policy shims implement no QueueSort, so appending is safe
            sched.framework.plugins.extend(self._build_custom_plugins(sched, custom_predicates, custom_priorities))
        return sched

    def _build_custom_plugins(self, sched, custom_predicates, custom_priorities):
        """Policy custom-argument predicates/priorities → framework plugins
        over the host commit path (RegisterCustomFitPredicate /
        RegisterCustomPriorityFunction, factory/plugins.go:127,363): the
        device mask cannot host user-named predicates, and Filter plugins
        already send every pod through the host re-check."""
        services = self.service_lister or (lambda: [])
        snap = lambda: sched.cache.snapshot  # noqa: E731
        plugins = []
        for spec in custom_predicates:
            kind = spec[0]
            if kind == "CheckNodeLabelPresence":
                _, name, labels, presence = spec
                plugins.append(predicate_plugin(
                    name,
                    lambda pod, ni, _l=labels, _p=presence: check_node_label_presence(pod, ni, _l, _p),
                    msg="node(s) didn't have the requested labels",
                ))
            elif kind == "ServiceAffinity":
                _, name, labels = spec
                plugins.append(ServiceAffinityPlugin(name, labels, snap, services))
        handle = Handle(snap)
        for spec in custom_priorities:
            kind = spec[0]
            if kind == "NodeLabel":
                _, name, weight, label, presence = spec
                plugins.append(priority_plugin(
                    name,
                    lambda pod, s, _l=label, _p=presence: node_label_priority(pod, s, _l, _p),
                    handle,
                    weight=weight,
                ))
            elif kind == "ServiceAntiAffinity":
                _, name, weight, label = spec
                plugins.append(priority_plugin(
                    name,
                    lambda pod, s, _l=label: service_anti_affinity_priority(pod, s, _l, services()),
                    handle,
                    weight=weight,
                ))
        return plugins
