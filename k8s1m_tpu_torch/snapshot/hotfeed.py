"""Pod shape keys: the structural fingerprint of a pod and its plane key.

Port of the key functions of ``k8s1m_tpu/snapshot/hotfeed.py``
(``PLAIN``, ``_SEP``, ``fingerprint``, ``shape_key``), host-only.  The
deltasched plane cache (``engine/deltacache.py``) keys a pod's cached
feasibility/score plane on ``shape_key``; two pods share a key in the
port exactly when they share one in the JAX package (the sentinels are
this module's own objects, so the keys themselves are not equal across
the two packages, only their partition of pods).  The encode cache and
the host feed of that module are coordinator machinery and arrive with
the coordinator port.
"""

from __future__ import annotations

from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

# Shared sentinel for the all-zero structural template: a plain pod
# (the 1M-KWOK steady state) has no structural parts at all.
PLAIN = object()

# Section separator of the flat fingerprint: variable-length sections back
# to back would be ambiguous ("ab"+"c" vs "a"+"bc").
_SEP = object()


def fingerprint(pod: PodInfo):
    """Hashable key over a pod's structural (template-cacheable) parts.

    Everything that flows into non-scalar encode output is included;
    scalars (cpu, mem, name, nodeName) are not.  Returns ``PLAIN`` for the
    all-default shape."""
    if not (
        pod.node_selector or pod.tolerations or pod.required_terms
        or pod.preferred_terms or pod.spread_refs or pod.affinity_refs
        or pod.spread_incs or pod.ipa_incs
    ):
        return PLAIN
    parts: list = [pod.scheduler_name]
    app = parts.append
    if pod.node_selector:
        for kv in sorted(pod.node_selector.items()):
            app(kv)
    app(_SEP)
    for t in pod.tolerations:
        app(t.key); app(t.op); app(t.value); app(t.effect)
    app(_SEP)
    for term in pod.required_terms:
        for e in term.match_expressions:
            app(e.key); app(e.op); app(tuple(e.values))
        app(_SEP)
    app(_SEP)
    for pt in pod.preferred_terms:
        app(pt.weight)
        for e in pt.term.match_expressions:
            app(e.key); app(e.op); app(tuple(e.values))
        app(_SEP)
    app(_SEP)
    for r in pod.spread_refs:
        app(r.cid); app(r.topo); app(r.max_skew); app(r.mode)
        app(r.self_match)
    app(_SEP)
    for r in pod.affinity_refs:
        app(r.tid); app(r.topo); app(r.required); app(r.anti)
        app(r.weight); app(r.self_match)
    app(_SEP)
    parts.extend(pod.spread_incs)
    app(_SEP)
    parts.extend(pod.ipa_incs)
    return tuple(parts)


def shape_key(pod: PodInfo):
    """Delta-plane cache key of a pod's filter+score plane, or None when
    the plane is not cacheable: the structural ``fingerprint`` plus the
    request scalars (Fit and the allocation scores read cpu/mem).

    Not cacheable: constraint-coupled pods (spread/affinity refs or incs
    read the live count tables, which no row-level dirty set can bound)
    and ``spec.nodeName`` pods (the baked name lookup can resolve
    differently after the name interns)."""
    if (
        pod.spread_refs or pod.affinity_refs
        or pod.spread_incs or pod.ipa_incs
        or pod.node_name is not None
    ):
        return None
    return (fingerprint(pod), pod.cpu_milli, pod.mem_kib)
