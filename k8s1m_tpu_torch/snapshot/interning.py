"""Host-side string interning (a copy of ``k8s1m_tpu/snapshot/interning.py``).

Labels, taints and selector values are strings in Kubernetes, but the
device only sees integer ids.  Every string that can appear in a
filter/score decision maps to a stable int32 id here, once; the device
never sees a new shape when new strings appear — ids are data.
"""

from __future__ import annotations

from k8s1m_tpu_torch.config import NO_NUMERIC, NONE_ID


class Interner:
    """Bidirectional value<->int table over hashables. Id 0 is "absent"."""

    def __init__(self) -> None:
        self._to_id: dict = {}
        self._to_val: list = [None]

    def intern(self, s) -> int:
        if s is None:
            return NONE_ID
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_val)
            self._to_id[s] = i
            self._to_val.append(s)
        return i

    def lookup(self, s) -> int:
        """Like intern, but NONE_ID for never-seen values: a query value
        that was never interned cannot match any node, and must not grow
        the table."""
        if s is None:
            return NONE_ID
        return self._to_id.get(s, NONE_ID)

    def value(self, i: int):
        return self._to_val[i]

    def __len__(self) -> int:
        return len(self._to_val)

    def __contains__(self, s) -> bool:
        return s in self._to_id

    def items(self):
        """Yields (id, value) for every interned value (skips the 0 slot)."""
        for i in range(1, len(self._to_val)):
            yield i, self._to_val[i]


# ASCII lead characters that make ``int(value, 10)`` unconditionally
# raise: the common non-numeric label value short-circuits on one set
# probe instead of paying the exception unwind.
_NONNUM_LEAD = frozenset(
    c for c in map(chr, range(33, 127)) if c not in "+-0123456789"
)


def numeric_of(value: str) -> int:
    """Integer value of a label for Gt/Lt selector ops, or NO_NUMERIC
    (upstream strconv.ParseInt: non-integers make Gt/Lt unsatisfiable)."""
    if isinstance(value, str) and value and value[0] in _NONNUM_LEAD:
        return NO_NUMERIC
    try:
        return int(value, 10)
    except (ValueError, TypeError):
        return NO_NUMERIC


class Vocab:
    """The full interning state shared by a snapshot; separate namespaces
    so a taint key and a label value never collide into a false match."""

    def __init__(self) -> None:
        self.label_keys = Interner()
        self.label_values = Interner()
        # Whole (key, value, effect) taint triples.
        self.taints = Interner()
        self.node_names = Interner()
        self.zones = Interner()
        self.regions = Interner()

    def generation(self) -> int:
        """Monotonic counter over the encode-relevant namespaces (label
        keys and values, taint triples): the hotfeed encode cache keys
        its templates on it.  Interners only grow, so the sum of lengths
        is a valid generation.  Node names, zones and regions are left
        out: node churn must not invalidate the shape cache."""
        return len(self.label_keys) + len(self.label_values) + len(self.taints)

    def feed_generation(self) -> int:
        """Staleness stamp of a fully encoded batch: ``generation()`` plus
        the node-name namespace, which the batch's ``node_name_id``
        column bakes."""
        return self.generation() + len(self.node_names)
