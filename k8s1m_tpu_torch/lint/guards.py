"""Runtime lock discipline: ``@guarded_by`` annotations + audit mode.

The port's own copy of ``k8s1m_tpu/lint/guards.py`` (pure Python).

Static analysis can prove a ``.item()`` never ships; it cannot prove the
webhook handler thread never touches the cycle thread's wave list.  This
module closes that gap with *declared* lock discipline, checked by a
test-only instrumentation mode:

    from k8s1m_tpu_torch.lint import guarded_by, THREAD_OWNER

    @guarded_by(
        _external="_external_lock",   # only while self._external_lock held
        _inflights=THREAD_OWNER,      # only from the owning thread
    )
    class Coordinator: ...

Guard kinds:

- ``"_lock_attr"`` — the field may be read or written only while the
  named instance lock is held *by the current thread*.  Lock holding is
  tracked by returning a thin tracking proxy from the lock attribute
  while auditing (works for Lock and RLock alike, no reliance on
  ``_is_owned``).
- ``THREAD_OWNER`` — the field is thread-confined: the first thread to
  touch any owner-guarded field of the instance claims ownership; any
  other thread's access raises.  ``set_owner(obj)`` re-claims for the
  current thread, ``disown(obj)`` clears the claim (legitimate handoff).

Production cost is zero: ``guarded_by`` only records the annotation.
``audit()`` (a context manager; tests only) patches each annotated
class's ``__getattribute__``/``__setattr__`` with checking versions and
restores the originals on exit.  Violations BOTH raise
``GuardViolation`` and append to ``violations()`` — a raise inside a
server handler thread is usually swallowed by that handler's own error
path, so the stress test asserts on the recorded list.
"""

from __future__ import annotations

import contextlib
import threading

THREAD_OWNER = "<thread-owner>"
_OWNER_KEY = "__guard_owner_tid__"

_registry: list[type] = []
_patched: dict[type, tuple] = {}
_enabled = False
_violations: list[str] = []
_state_lock = threading.Lock()
_tls = threading.local()


class GuardViolation(AssertionError):
    """A guarded field was accessed without its declared protection."""


def guarded_by(**fields: str):
    """Class decorator declaring per-field guards (see module doc)."""

    def deco(cls: type) -> type:
        merged: dict[str, str] = {}
        for base in reversed(cls.__mro__[1:]):
            merged.update(getattr(base, "__guards__", None) or {})
        merged.update(fields)
        cls.__guards__ = merged
        with _state_lock:
            _registry.append(cls)
            if _enabled:
                _patch(cls)
        return cls

    return deco


def violations() -> list[str]:
    return list(_violations)


def racy_read(obj, name: str):
    """Deliberate unguarded read of a guarded field, bypassing the audit.

    For monitoring paths ONLY (metrics scrape callbacks, debug dumps):
    a ``len()`` of a list/deque owned by another thread is a benign
    torn-snapshot read under CPython, and a scrape must neither block on
    the cycle thread's locks nor count as a discipline violation.  The
    explicit call is the audit record — grep ``racy_read`` to enumerate
    every sanctioned unguarded access.  Never use it to *mutate*, or to
    read state whose torn value feeds a control decision.
    """
    return object.__getattribute__(obj, name)


def audit_enabled() -> bool:
    return _enabled


def set_owner(obj) -> None:
    """Claim (or re-claim) owner-guarded fields of ``obj`` for the
    current thread — the explicit handoff when an object is built on
    one thread and driven from another."""
    obj.__dict__[_OWNER_KEY] = threading.get_ident()


def disown(obj) -> None:
    obj.__dict__.pop(_OWNER_KEY, None)


# ---- lock-holding ledger ----------------------------------------------


def _held_map() -> dict[int, int]:
    m = getattr(_tls, "held", None)
    if m is None:
        m = _tls.held = {}
    return m


class _TrackedLock:
    """Context-manager/acquire-release proxy that records holding in a
    thread-local ledger keyed by the REAL lock's id (so every proxy of
    the same lock agrees)."""

    __slots__ = ("_lk",)

    def __init__(self, lk):
        object.__setattr__(self, "_lk", lk)

    def acquire(self, *a, **kw):
        ok = self._lk.acquire(*a, **kw)
        if ok:
            m = _held_map()
            m[id(self._lk)] = m.get(id(self._lk), 0) + 1
        return ok

    def release(self):
        m = _held_map()
        n = m.get(id(self._lk), 0)
        if n <= 1:
            m.pop(id(self._lk), None)
        else:
            m[id(self._lk)] = n - 1
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lk.locked()

    def __getattr__(self, name):
        return getattr(self._lk, name)


def _note_violation(msg: str) -> None:
    with _state_lock:
        _violations.append(msg)
    raise GuardViolation(msg)


# ---- class patching ----------------------------------------------------


def _unwrap(fn):
    """Skip any checking wrappers inherited from an already-patched base
    class — a subclass's wrapper must delegate to REAL behavior, and
    unpatching must never mistake a parent's wrapper for an original."""
    while getattr(fn, "_graftlint_wrapper", False):
        fn = fn.__wrapped__
    return fn


def _patch(cls: type) -> None:
    if cls in _patched:
        return
    guards: dict[str, str] = cls.__guards__
    lock_attrs = {g for g in guards.values() if g != THREAD_OWNER}
    # What THIS class defines in its own __dict__ (None = inherited):
    # unpatching restores these, or deletes our wrapper so inheritance
    # resumes — saving the MRO-resolved attribute would freeze a parent
    # class's (possibly checking) method onto the subclass forever.
    own = {
        name: cls.__dict__.get(name)
        for name in ("__getattribute__", "__setattr__", "__init__")
    }
    orig_get = _unwrap(cls.__getattribute__)
    orig_set = _unwrap(cls.__setattr__)
    orig_init = _unwrap(cls.__init__)

    def checking_init(self, *a, **kw):
        # Construction is single-threaded by definition (no other thread
        # holds a reference yet): guarded fields may be initialized
        # freely, and THREAD_OWNER ownership is claimed by the first
        # POST-construction accessor — which naturally supports the
        # construct-on-main, drive-on-worker pattern.
        d = object.__getattribute__(self, "__dict__")
        d["__guard_init_depth__"] = d.get("__guard_init_depth__", 0) + 1
        try:
            orig_init(self, *a, **kw)
        finally:
            d["__guard_init_depth__"] = d["__guard_init_depth__"] - 1

    def check(self, name: str, mode: str) -> None:
        if object.__getattribute__(self, "__dict__").get(
            "__guard_init_depth__", 0
        ):
            return
        guard = guards[name]
        if guard == THREAD_OWNER:
            tid = threading.get_ident()
            d = object.__getattribute__(self, "__dict__")
            # Atomic claim (setdefault under the GIL): a check-then-set
            # here would let two first-touching threads both claim —
            # missing the exact cross-thread race being audited, then
            # flagging the loser's next legitimate access.
            owner = d.setdefault(_OWNER_KEY, tid)
            if owner != tid:
                _note_violation(
                    f"{type(self).__name__}.{name} {mode} from thread "
                    f"{threading.current_thread().name} but owned by "
                    f"thread id {owner} (thread-confined field)"
                )
            return
        try:
            lock = orig_get(self, guard)
        except AttributeError:
            return          # under construction: the lock doesn't exist yet
        real = lock._lk if isinstance(lock, _TrackedLock) else lock
        if _held_map().get(id(real), 0) <= 0:
            _note_violation(
                f"{type(self).__name__}.{name} {mode} without {guard} "
                f"held (thread {threading.current_thread().name})"
            )

    def checking_get(self, name):
        if name in guards:
            check(self, name, "read")
        val = orig_get(self, name)
        if name in lock_attrs and not isinstance(val, _TrackedLock):
            return _TrackedLock(val)
        return val

    def checking_set(self, name, value):
        if name in guards:
            check(self, name, "write")
        orig_set(self, name, value)

    for wrapper, orig in (
        (checking_get, orig_get),
        (checking_set, orig_set),
        (checking_init, orig_init),
    ):
        wrapper._graftlint_wrapper = True
        wrapper.__wrapped__ = orig
    cls.__getattribute__ = checking_get
    cls.__setattr__ = checking_set
    cls.__init__ = checking_init
    _patched[cls] = own


def _unpatch_all() -> None:
    for cls, own in _patched.items():
        for name, orig in own.items():
            if orig is not None:
                setattr(cls, name, orig)
            else:
                # The class only had our wrapper: remove it so the
                # attribute resolves through the MRO again.
                delattr(cls, name)
    _patched.clear()


def enable_audit() -> None:
    global _enabled
    with _state_lock:
        if _enabled:
            return
        _enabled = True
        _violations.clear()
        for cls in _registry:
            _patch(cls)


def disable_audit() -> None:
    global _enabled
    with _state_lock:
        if not _enabled:
            return
        _enabled = False
        _unpatch_all()


@contextlib.contextmanager
def audit():
    """Test-scope instrumentation window; restores classes on exit.
    ``violations()`` stays readable after exit (cleared at next enable)."""
    enable_audit()
    try:
        yield
    finally:
        disable_audit()
