"""Kubernetes-shaped object codec for the store the coordinator watches.

The port's own copy of ``k8s1m_tpu/control/objects.py``: nodes and pods
are stored as JSON in the Kubernetes object shapes under the
kube-apiserver registry keys,

- nodes:  /registry/minions/<name>
- pods:   /registry/pods/<namespace>/<name>
- leases: /registry/leases/<namespace>/<name>

and the same writes leave the same bytes in either package's store.
``decode_pod`` compiles inline affinity / topologySpreadConstraint specs
into interned slot references through a ConstraintTracker.  The byte-scan
fast parsers (``decode_node_fast``, ``decode_pod_fast``) accept exactly the
canonical shapes the encoders write and fall back to ``json.loads``
otherwise; ``CANONICAL_NODE_RE`` is the bulk cold-build lane's grammar
(``snapshot/bulkload.py``).
"""

from __future__ import annotations

import json
import re

from k8s1m_tpu_torch.config import (
    K8S_DEFAULT_SCHEDULER,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_NONE,
    EFFECT_PREFER_NO_SCHEDULE,
    SEL_OP_DOES_NOT_EXIST,
    SEL_OP_EXISTS,
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_LT,
    SEL_OP_NOT_IN,
    SPREAD_DO_NOT_SCHEDULE,
    SPREAD_SCHEDULE_ANYWAY,
    TOL_OP_EQUAL,
    TOL_OP_EXISTS,
    TOPO_HOSTNAME,
    TOPO_REGION,
    TOPO_ZONE,
)
from k8s1m_tpu_torch.snapshot.records import (
    AffinityTermRef,
    ConstraintTracker,
    NodeInfo,
    NodeSelectorTerm,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SpreadConstraintRef,
    Taint,
    Toleration,
    pod_priority_of,
)


_EFFECTS = {
    "": EFFECT_NONE,
    "NoSchedule": EFFECT_NO_SCHEDULE,
    "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
    "NoExecute": EFFECT_NO_EXECUTE,
}
_EFFECT_NAMES = {v: k for k, v in _EFFECTS.items()}
_SEL_OPS = {
    "In": SEL_OP_IN,
    "NotIn": SEL_OP_NOT_IN,
    "Exists": SEL_OP_EXISTS,
    "DoesNotExist": SEL_OP_DOES_NOT_EXIST,
    "Gt": SEL_OP_GT,
    "Lt": SEL_OP_LT,
}
_SEL_OP_NAMES = {v: k for k, v in _SEL_OPS.items()}
_TOPO_KEYS = {
    "kubernetes.io/hostname": TOPO_HOSTNAME,
    "topology.kubernetes.io/zone": TOPO_ZONE,
    "topology.kubernetes.io/region": TOPO_REGION,
}
_TOPO_NAMES = {v: k for k, v in _TOPO_KEYS.items()}

_BIN_SUFFIX = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40}
_DEC_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def node_key(name: str) -> bytes:
    return f"/registry/minions/{name}".encode()


def pod_key(namespace: str, name: str) -> bytes:
    return f"/registry/pods/{namespace}/{name}".encode()


def lease_key(namespace: str, name: str) -> bytes:
    return f"/registry/leases/{namespace}/{name}".encode()


def pod_key_str_of_obj(obj: dict) -> str:
    """``"<ns>/<name>"`` for a pod manifest dict — the ``PodInfo.key``
    shape (unset namespace = "default", upstream semantics).  The ONE
    derivation the webhook and ``submit_external`` both use for
    podtrace keys: the two sites must produce byte-identical keys or a
    webhook-opened trace never matches the coordinator's chain."""
    md = obj.get("metadata") or {}
    return f"{md.get('namespace') or 'default'}/{md.get('name', '')}"


# ---- quantities ------------------------------------------------------------


def parse_cpu(q: str | int | float) -> int:
    """Kubernetes cpu quantity -> milliCPU ("2" -> 2000, "500m" -> 500)."""
    if isinstance(q, (int, float)):
        return int(q * 1000)
    q = q.strip()
    if q.endswith("m"):
        return int(q[:-1])
    return int(float(q) * 1000)


def parse_mem(q: str | int | float) -> int:
    """Kubernetes memory quantity -> KiB ("8Gi" -> 8388608, bare -> bytes)."""
    if isinstance(q, (int, float)):
        return int(q) >> 10
    q = q.strip()
    for suf, mult in _BIN_SUFFIX.items():
        if q.endswith(suf):
            return int(float(q[: -len(suf)]) * mult) >> 10
    for suf, mult in _DEC_SUFFIX.items():
        if q.endswith(suf):
            return int(float(q[: -len(suf)]) * mult) >> 10
    return int(float(q)) >> 10


def cpu_str(milli: int) -> str:
    return f"{milli}m"


def mem_str(kib: int) -> str:
    return f"{kib}Ki"


# ---- Node ------------------------------------------------------------------


def encode_node(node: NodeInfo) -> bytes:
    obj = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": node.name, "labels": dict(node.labels)},
        "spec": {},
        "status": {
            "allocatable": {
                "cpu": cpu_str(node.cpu_milli),
                "memory": mem_str(node.mem_kib),
                "pods": str(node.pods),
            },
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }
    if node.unschedulable:
        obj["spec"]["unschedulable"] = True
    if node.taints:
        obj["spec"]["taints"] = [
            {"key": t.key, "value": t.value, "effect": _EFFECT_NAMES[t.effect]}
            for t in node.taints
        ]
    return json.dumps(obj, separators=(",", ":")).encode()


def decode_node(data: bytes) -> NodeInfo:
    node = decode_node_fast(data)
    if node is not None:
        return node
    obj = json.loads(data)
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    alloc = obj.get("status", {}).get("allocatable", {})
    return NodeInfo(
        name=meta["name"],
        labels=dict(meta.get("labels", {})),
        cpu_milli=parse_cpu(alloc.get("cpu", "0")),
        mem_kib=parse_mem(alloc.get("memory", "0")),
        pods=int(alloc.get("pods", 0)),
        unschedulable=bool(spec.get("unschedulable", False)),
        taints=[
            Taint(t["key"], t.get("value", ""), _EFFECTS[t.get("effect", "")])
            for t in spec.get("taints", [])
        ],
    )


# Exact grammar of encode_node's output for a plain schedulable node
# (no taints, no unschedulable, fixed Ready conditions): the bulk
# cold-build lane (snapshot/bulkload.py) FULLMATCHES a value against
# this and reads the captures directly — name, raw label blob, cpu
# milli, mem KiB, pods.  Everything variable is captured by character
# classes that exclude quotes, backslashes and control bytes, so a
# fullmatch parses byte-identically to json.loads by construction
# (json.dumps ensure_ascii escapes non-ASCII into backslash sequences,
# which simply fail the match); any other shape — heartbeat-churned
# status, taints, escapes — falls back to decode_node per value.
_S = rb'[^"\\\x00-\x1f]*'
CANONICAL_NODE_RE = re.compile(
    rb'\{"apiVersion":"v1","kind":"Node","metadata":\{"name":"(' + _S +
    rb')","labels":\{((?:"' + _S + rb'":"' + _S +
    rb'"(?:,"' + _S + rb'":"' + _S + rb'")*)?)\}\},"spec":\{\},'
    rb'"status":\{"allocatable":\{"cpu":"(\d+)m","memory":"(\d+)Ki",'
    rb'"pods":"(\d+)"\},"conditions":\[\{"type":"Ready","status":'
    rb'"True"\}\]\}\}'
)
# One label pair inside the captured blob (the blob grammar above
# guarantees findall reconstructs it exactly; duplicate keys resolve
# last-wins below, matching json.loads).
CANONICAL_LABEL_RE = re.compile(rb'"(' + _S + rb')":"(' + _S + rb')"')

# Byte landmarks of the canonical encode_node shape (same restricted-
# parser contract as decode_pod_fast): accepted iff the metadata prefix
# matches exactly, spec is EMPTY (taints/unschedulable fall back to the
# JSON path), and allocatable uses the canonical "<n>m"/"<n>Ki" units.
# Anything after allocatable.pods — conditions, kubelet heartbeats — is
# deliberately ignored: the scheduler reads nothing from node status
# beyond allocatable, so status-churning writers stay on the fast path.
_FN_HEAD = b'{"apiVersion":"v1","kind":"Node","metadata":{"name":"'
_FN_LABELS = b'","labels":{'
# spec must be empty AND allocatable must open status — anchored as one
# contiguous landmark so a nested "allocatable" deeper in status can
# never be mistaken for the real one (the fast path must parse bytes
# identically to the JSON path or not at all).
_FN_SPEC_ALLOC = b'},"spec":{},"status":{"allocatable":{"cpu":"'
_FN_MEM = b'","memory":"'
_FN_PODS = b'","pods":"'


def _scan_labels(data: bytes, i: int):
    """Parse a flat {"k":"v",...} object of plain strings starting at
    ``i`` (just past the opening brace).  Returns (labels, index past the
    closing brace) or None for any other shape — shared by the canonical
    pod and node fast parsers so their escape/quote handling can never
    drift apart."""
    labels: dict[str, str] = {}
    if data[i : i + 1] == b"}":
        return labels, i + 1
    while True:
        if data[i : i + 1] != b'"':
            return None
        j = data.find(b'"', i + 1)
        lk = data[i + 1 : j]
        if data[j : j + 3] != b'":"':
            return None
        i = j + 3
        j = data.find(b'"', i)
        labels[lk.decode()] = data[i:j].decode()
        nxt = data[j + 1 : j + 2]
        i = j + 2
        if nxt == b",":
            continue
        if nxt == b"}":
            return labels, i
        return None


_WS = b" \t\n\r"
# Keys whose re-appearance would shadow state the fast path already
# consumed (json.loads is last-wins; the byte scanner is first-wins).
_DUP_STATUS_KEYS = frozenset((b"allocatable",))
_DUP_TOP_KEYS = frozenset((b"metadata", b"spec", b"status"))


# Any raw control byte anywhere in the value demotes to the JSON path:
# valid compact JSON (what every canonical writer emits) contains none,
# and inside strings json.loads rejects them — one C-level scan closes
# that divergence for the whole value, parsed span and tail alike.
_CTRL_RE = re.compile(rb"[\x00-\x1f]")

# RFC 8259 number grammar (json.loads rejects 01, 1., .5, bare -).
_NUM_PAT = rb"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_NUM_RE = re.compile(_NUM_PAT)

# Fast-accept for the hot tail shape — a flat conditions array of
# string/number/bool/null fields (the framework's own encoder plus
# kubelet-style heartbeat churn), matched in one C-level regex pass so
# the Python FSM below only ever runs on exotic tails.  Strings here are
# printable-ASCII-only (no quote/backslash/ctrl); anything else (UTF-8
# text, nesting, ws) falls to the FSM.  The shape admits no status-level
# key but "conditions" and no top-level key at all, so duplicate
# landmarks cannot hide in a fast-accepted tail.
_STR_PAT = rb'"[ !#-\[\]-~]*"'
_CONDV_PAT = rb"(?:" + _STR_PAT + rb"|" + _NUM_PAT + rb"|true|false|null)"
_CONDKV_PAT = _STR_PAT + rb":" + _CONDV_PAT
_CONDOBJ_PAT = rb"\{(?:" + _CONDKV_PAT + rb"(?:," + _CONDKV_PAT + rb")*)?\}"
_TAIL_CANON_RE = re.compile(
    rb'\}(?:,"conditions":\[(?:'
    + _CONDOBJ_PAT
    + rb"(?:,"
    + _CONDOBJ_PAT
    + rb")*)?\])?\}\}\Z"
)


def _node_tail_ok(data: bytes, i: int) -> bool:
    """Validate the unparsed tail of a canonical node value, starting
    just past allocatable's closing brace (inside the status object,
    expecting ',' or '}').

    Two jobs, both required for the fast path's contract ("parse
    identically to json.loads or not at all"):
      1. reject duplicate landmark KEYS json.loads would last-win — a
         second "allocatable" at the status level, a second metadata/
         spec/status at the top level;
      2. reject malformed tails json.loads would raise on (garbage
         literals, mismatched brackets, bad commas), so corrupted bytes
         never parse fast while raising for every pure-JSON consumer.
    A strict streaming validator over the (short) conditions tail.
    Tokenizing is simple because the caller already rejected values
    containing backslashes or control bytes: a quote always terminates a
    string.  This is the SLOW fallback — the caller fast-accepts the
    canonical conditions shape with _TAIL_CANON_RE first, so this runs
    only on exotic tails.
    """
    try:
        # json.loads(bytes) decodes UTF-8 first; tail strings are never
        # decoded by the fast path, so validate here or diverge on
        # invalid UTF-8.
        data[i:].decode()
    except UnicodeDecodeError:
        return False
    n = len(data)
    # Container stack: True = object, False = array.  We start inside
    # status, whose parent is the root object; a key is status-level
    # when len(stack) == 2 and top-level when len(stack) == 1.
    stack = [True, True]
    COMMA_OR_CLOSE, KEY, COLON, VALUE, FIRST_KEY, FIRST_VALUE = range(6)
    state = COMMA_OR_CLOSE
    while True:
        while i < n and data[i] in _WS:
            i += 1
        if not stack:
            return i == n          # root closed; only ws may trail
        if i >= n:
            return False           # truncated
        c = data[i]
        if state == COMMA_OR_CLOSE:
            if c == 0x2C:          # ','
                i += 1
                state = KEY if stack[-1] else VALUE
            elif c == (0x7D if stack[-1] else 0x5D):   # '}' / ']'
                stack.pop()
                i += 1
            else:
                return False
        elif state == KEY:
            if c != 0x22:          # '"'
                return False
            q = data.find(b'"', i + 1)
            if q < 0:
                return False
            key = data[i + 1 : q]
            if len(stack) == 2 and key in _DUP_STATUS_KEYS:
                return False
            if len(stack) == 1 and key in _DUP_TOP_KEYS:
                return False
            i = q + 1
            state = COLON
        elif state == COLON:
            if c != 0x3A:          # ':'
                return False
            i += 1
            state = VALUE
        elif state == VALUE:
            if c == 0x22:          # string
                q = data.find(b'"', i + 1)
                if q < 0:
                    return False
                i = q + 1
                state = COMMA_OR_CLOSE
            elif c == 0x7B:        # '{'
                stack.append(True)
                i += 1
                state = FIRST_KEY
            elif c == 0x5B:        # '['
                stack.append(False)
                i += 1
                state = FIRST_VALUE
            elif data.startswith(b"true", i):
                i += 4
                state = COMMA_OR_CLOSE
            elif data.startswith(b"false", i):
                i += 5
                state = COMMA_OR_CLOSE
            elif data.startswith(b"null", i):
                i += 4
                state = COMMA_OR_CLOSE
            else:
                m = _NUM_RE.match(data, i)
                if m is None:
                    return False
                i = m.end()
                state = COMMA_OR_CLOSE
        elif state == FIRST_KEY:
            if c == 0x7D:          # '}': empty object
                stack.pop()
                i += 1
                state = COMMA_OR_CLOSE
            else:
                state = KEY        # no advance; re-dispatch this char
        else:                      # FIRST_VALUE
            if c == 0x5D:          # ']': empty array
                stack.pop()
                i += 1
                state = COMMA_OR_CLOSE
            else:
                state = VALUE      # no advance; re-dispatch this char


def decode_node_fast(data: bytes) -> NodeInfo | None:
    """Parse the canonical node shape with byte scans; None = use JSON.

    The node-decode analogue of decode_pod_fast: a 1M-node bootstrap (or
    a heartbeat-churning watch stream) otherwise spends ~26µs/node in
    json.loads for objects this framework's own encoders wrote.
    """
    if not data.startswith(_FN_HEAD) or b"\\" in data or _CTRL_RE.search(data):
        return None
    i = len(_FN_HEAD)
    j = data.find(b'"', i)
    name = data[i:j]
    if not data.startswith(_FN_LABELS, j):
        return None
    scanned = _scan_labels(data, j + len(_FN_LABELS))
    if scanned is None:
        return None
    labels, i = scanned
    if not data.startswith(_FN_SPEC_ALLOC, i):
        return None
    i += len(_FN_SPEC_ALLOC)
    j = data.find(b'"', i)
    cpu_b = data[i:j]
    if not data.startswith(_FN_MEM, j):
        return None
    i = j + len(_FN_MEM)
    j = data.find(b'"', i)
    mem_b = data[i:j]
    if not data.startswith(_FN_PODS, j):
        return None
    i = j + len(_FN_PODS)
    j = data.find(b'"', i)
    pods_b = data[i:j]
    if not cpu_b.endswith(b"m") or not mem_b.endswith(b"Ki"):
        return None
    # allocatable must CLOSE right after pods (a further key in it —
    # e.g. a duplicate "cpu" — would last-win under json.loads while the
    # scan above already consumed the first).
    if data[j + 1 : j + 2] != b"}":
        return None
    # The rest of the tail (conditions, heartbeat noise) is unparsed —
    # but json.loads is last-wins for duplicate keys, so a later
    # duplicate of any landmark we already consumed would make the two
    # paths disagree, and a malformed tail would parse fast while
    # raising for every pure-JSON consumer.  One C-level regex accepts
    # the hot heartbeat shape; anything else takes the strict FSM walk.
    if _TAIL_CANON_RE.match(data, j + 1) is None and not _node_tail_ok(
        data, j + 2
    ):
        return None
    try:
        return NodeInfo(
            name=name.decode(),
            labels=labels,
            cpu_milli=int(cpu_b[:-1]),
            mem_kib=int(mem_b[:-2]),
            pods=int(pods_b),
        )
    except ValueError:
        return None


# ---- Pod -------------------------------------------------------------------


def _encode_term(term: NodeSelectorTerm) -> dict:
    return {
        "matchExpressions": [
            {
                "key": r.key,
                "operator": _SEL_OP_NAMES[r.op],
                **({"values": list(r.values)} if r.values else {}),
            }
            for r in term.match_expressions
        ]
    }


def _decode_term(obj: dict) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[
            SelectorRequirement(
                key=e["key"],
                op=_SEL_OPS[e["operator"]],
                values=list(e.get("values", [])),
            )
            for e in obj.get("matchExpressions", [])
        ]
    )


def encode_pod(pod: PodInfo, *, scheduler_name: str | None = None,
               raw_affinity: dict | None = None,
               raw_spread: list | None = None) -> bytes:
    """PodInfo -> Kubernetes-shaped JSON.

    Slot references (spread_refs/affinity_refs) are a compiled, tracker-
    relative form, so callers that built the pod from raw constraint specs
    pass them through ``raw_affinity``/``raw_spread`` for re-encoding.
    """
    spec: dict = {
        "schedulerName": scheduler_name or pod.scheduler_name,
        "containers": [
            {
                "name": "app",
                "image": "img",
                "resources": {
                    "requests": {
                        "cpu": cpu_str(pod.cpu_milli),
                        "memory": mem_str(pod.mem_kib),
                    }
                },
            }
        ],
    }
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [
            {
                **({"key": t.key} if t.key else {}),
                "operator": "Exists" if t.op == TOL_OP_EXISTS else "Equal",
                **({"value": t.value} if t.value else {}),
                **(
                    {"effect": _EFFECT_NAMES[t.effect]}
                    if t.effect != EFFECT_NONE
                    else {}
                ),
            }
            for t in pod.tolerations
        ]
    affinity = dict(raw_affinity or {})
    if pod.required_terms or pod.preferred_terms:
        node_aff: dict = {}
        if pod.required_terms:
            node_aff["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [_encode_term(t) for t in pod.required_terms]
            }
        if pod.preferred_terms:
            node_aff["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": p.weight, "preference": _encode_term(p.term)}
                for p in pod.preferred_terms
            ]
        affinity["nodeAffinity"] = node_aff
    if affinity:
        spec["affinity"] = affinity
    if raw_spread:
        spec["topologySpreadConstraints"] = list(raw_spread)
    if pod.priority:
        # Appended after the canonical fields: spec still OPENS with
        # schedulerName, so the bind splice landmark is unchanged; the
        # extra key makes the object non-canonical for the byte-scan
        # fast parsers, which is correct — priority-bearing pods belong
        # on the full decode path where admission/preemption read it.
        spec["priority"] = int(pod.priority)
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "labels": dict(pod.labels),
        },
        "spec": spec,
        "status": {"phase": "Pending"},
    }
    return json.dumps(obj, separators=(",", ":")).encode()


def decode_pod(data: bytes, tracker: ConstraintTracker | None = None) -> PodInfo:
    """JSON -> PodInfo; inline constraints are interned via ``tracker``.

    Without a tracker, podAffinity/topologySpreadConstraints are ignored
    (the caller only wants identity/resources — e.g. load accounting).
    """
    pod = decode_pod_fast(data, tracker)
    if pod is not None:
        return pod
    return decode_pod_obj(json.loads(data), tracker)


# Byte landmarks of the canonical encode_pod shape.  The fast parser
# accepts EXACTLY the objects this module's encode_pod emits for pods with
# no selectors/tolerations/affinity/spread (plus the nodeName-spliced bind
# form) — anything else, including any backslash escape anywhere, falls
# back to the full JSON path.  This is the restricted-parser analogue of
# the reference's empirically-restricted Txn support (one shape, fast;
# everything else rejected — kv_service.rs:126-337).
_FP_HEAD = b'{"apiVersion":"v1","kind":"Pod","metadata":{"name":"'
_FP_NS = b'","namespace":"'
_FP_LABELS = b'","labels":{'
_FP_NODE = b'"nodeName":"'
_FP_SCHED = b'"schedulerName":"'
_FP_CONTAINERS = (
    b'","containers":[{"name":"app","image":"img",'
    b'"resources":{"requests":{"cpu":"'
)
_FP_MEM = b'","memory":"'
_FP_TAIL = b'"}}}]},"status":{"phase":"Pending"}}'
# encode_pod appends nodeName after containers (dict insertion order);
# the bind splice inserts it before schedulerName.  Accept both.
_FP_NODE_TAIL = b'"}}}],"nodeName":"'
_FP_STATUS = b'"},"status":{"phase":"Pending"}}'


def decode_pod_fast(
    data: bytes, tracker: ConstraintTracker | None = None
) -> PodInfo | None:
    """Parse the canonical pod shape with byte scans; None = not canonical.

    ~4x faster than json.loads + decode_pod_obj on the watch firehose,
    where nearly every object is one this framework's own encoders wrote.
    """
    if not data.startswith(_FP_HEAD) or b"\\" in data:
        return None
    i = len(_FP_HEAD)
    j = data.find(b'"', i)
    name = data[i:j]
    if not data.startswith(_FP_NS, j):
        return None
    i = j + len(_FP_NS)
    j = data.find(b'"', i)
    namespace = data[i:j]
    if not data.startswith(_FP_LABELS, j):
        return None
    scanned = _scan_labels(data, j + len(_FP_LABELS))
    if scanned is None:
        return None
    labels, i = scanned
    if data[i : i + 10] != b'},"spec":{':
        return None
    i += 10
    node_name = None
    if data.startswith(_FP_NODE, i):
        i += len(_FP_NODE)
        j = data.find(b'"', i)
        node_name = data[i:j].decode()
        if data[j : j + 2] != b'",':
            return None
        i = j + 2
    if not data.startswith(_FP_SCHED, i):
        return None
    i += len(_FP_SCHED)
    j = data.find(b'"', i)
    scheduler_name = data[i:j]
    if not data.startswith(_FP_CONTAINERS, j):
        return None
    i = j + len(_FP_CONTAINERS)
    j = data.find(b'"', i)
    cpu_b = data[i:j]
    if not data.startswith(_FP_MEM, j):
        return None
    i = j + len(_FP_MEM)
    j = data.find(b'"', i)
    mem_b = data[i:j]
    # The tail must be the EXACT remainder: proves there is no
    # nodeSelector/tolerations/affinity/topologySpreadConstraints.
    if data[j:] != _FP_TAIL:
        if node_name is not None or not data.startswith(_FP_NODE_TAIL, j):
            return None
        i = j + len(_FP_NODE_TAIL)
        j = data.find(b'"', i)
        node_name = data[i:j].decode()
        if data[j:] != _FP_STATUS:
            return None
    if not cpu_b.endswith(b"m") or not mem_b.endswith(b"Ki"):
        return None
    try:
        cpu = int(cpu_b[:-1])
        mem = int(mem_b[:-2])
    except ValueError:
        return None

    pod = PodInfo(
        name=name.decode(),
        namespace=namespace.decode(),
        labels=labels,
        cpu_milli=cpu,
        mem_kib=mem,
        scheduler_name=scheduler_name.decode(),
        node_name=node_name,
    )
    if tracker is not None:
        ns = pod.namespace
        pod.spread_incs = tracker.spread_matches(ns, labels)
        pod.ipa_incs = tracker.affinity_matches(ns, labels)
    return pod


def decode_pod_obj(obj: dict, tracker: ConstraintTracker | None = None) -> PodInfo:
    """dict -> PodInfo (webhook intake already holds the parsed object)."""
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    namespace = meta.get("namespace", "default")
    labels = dict(meta.get("labels", {}))

    cpu = mem = 0
    for c in spec.get("containers", []):
        req = c.get("resources", {}).get("requests", {})
        cpu += parse_cpu(req.get("cpu", 0))
        mem += parse_mem(req.get("memory", 0))

    pod = PodInfo(
        name=meta["name"],
        namespace=namespace,
        labels=labels,
        cpu_milli=cpu,
        mem_kib=mem,
        # Kubernetes semantics: an unset schedulerName belongs to
        # "default-scheduler", NOT to this framework's scheduler — the
        # reference's intake filter only claims explicitly-marked pods
        # (webhook.go:102-125).
        scheduler_name=spec.get("schedulerName", K8S_DEFAULT_SCHEDULER),
        node_name=spec.get("nodeName"),
        # Same forgiving parse as ops/priority.pod_priority_of: a pod
        # with a garbage priority schedules at 0, it is not rejected.
        priority=pod_priority_of(obj),
        node_selector=dict(spec.get("nodeSelector", {})),
        tolerations=[
            Toleration(
                key=t.get("key", ""),
                op=TOL_OP_EXISTS if t.get("operator", "Equal") == "Exists" else TOL_OP_EQUAL,
                value=t.get("value", ""),
                effect=_EFFECTS[t.get("effect", "")],
            )
            for t in spec.get("tolerations", [])
        ],
    )

    aff = spec.get("affinity", {})
    node_aff = aff.get("nodeAffinity", {})
    req = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution", {})
    pod.required_terms = [_decode_term(t) for t in req.get("nodeSelectorTerms", [])]
    pod.preferred_terms = [
        PreferredSchedulingTerm(weight=p.get("weight", 1), term=_decode_term(p["preference"]))
        for p in node_aff.get("preferredDuringSchedulingIgnoredDuringExecution", [])
    ]

    if tracker is not None:
        for sc in spec.get("topologySpreadConstraints", []):
            topo = _TOPO_KEYS.get(sc.get("topologyKey", ""))
            if topo is None:
                raise ValueError(
                    f"pod {pod.key}: unsupported topologyKey {sc.get('topologyKey')!r}"
                )
            selector = dict(sc.get("labelSelector", {}).get("matchLabels", {}))
            cid = tracker.spread_slot(namespace, selector, topo)
            pod.spread_refs.append(
                SpreadConstraintRef(
                    cid=cid,
                    topo=topo,
                    max_skew=sc.get("maxSkew", 1),
                    mode=(
                        SPREAD_SCHEDULE_ANYWAY
                        if sc.get("whenUnsatisfiable") == "ScheduleAnyway"
                        else SPREAD_DO_NOT_SCHEDULE
                    ),
                    self_match=ConstraintTracker.selector_matches(selector, labels),
                )
            )
        for kind in ("podAffinity", "podAntiAffinity"):
            sub = aff.get(kind, {})
            anti = kind == "podAntiAffinity"
            for term in sub.get("requiredDuringSchedulingIgnoredDuringExecution", []):
                pod.affinity_refs.append(
                    _decode_ipa_term(tracker, namespace, labels, term, True, anti, 1)
                )
            for wt in sub.get("preferredDuringSchedulingIgnoredDuringExecution", []):
                pod.affinity_refs.append(
                    _decode_ipa_term(
                        tracker, namespace, labels, wt["podAffinityTerm"],
                        False, anti, wt.get("weight", 1),
                    )
                )
        pod.spread_incs = tracker.spread_matches(namespace, labels)
        pod.ipa_incs = tracker.affinity_matches(namespace, labels)
    return pod


def _decode_ipa_term(
    tracker: ConstraintTracker,
    namespace: str,
    labels: dict[str, str],
    term: dict,
    required: bool,
    anti: bool,
    weight: int,
) -> AffinityTermRef:
    topo = _TOPO_KEYS.get(term.get("topologyKey", ""))
    if topo is None:
        raise ValueError(f"unsupported podAffinity topologyKey {term.get('topologyKey')!r}")
    selector = dict(term.get("labelSelector", {}).get("matchLabels", {}))
    tid = tracker.affinity_slot(namespace, selector, topo)
    return AffinityTermRef(
        tid=tid,
        topo=topo,
        required=required,
        anti=anti,
        weight=weight,
        self_match=ConstraintTracker.selector_matches(selector, labels),
    )
