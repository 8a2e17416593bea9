"""The deltasched plane tail: per-pod hashed top-K over the merged planes.

Port of ``k8s1m_tpu/ops/pallas_topk.py:1038-1205`` (``_delta_kernel``,
``_delta_call``, ``delta_plane_topk``).  Each pod reads its shape slot's
row of the merged feasibility plane ``bool[S, N]`` and score plane
``i32[S, N]``, packs ``clip(score, 0, 2047) << 20 | hash_jitter(seed, pod
+ pod_offset, col + row_offset, stratum_bits)`` where feasible, and keeps
its top K by (priority descending, earlier column first).

- ``delta_plane_topk`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/delta_topk.cu`` and counts the launch in
  ``delta_plane_topk.launches``; on CPU tensors it runs the plain version
  ``engine/deltacache.py::plane_topk``.  There is no other path: anything
  the kernel does not take raises, and a failed build or launch raises.
- Slot ids clip to ``[0, S-1]`` in the kernel, as in the Pallas one; the
  plain version follows the XLA function it ports (``jnp.take`` fills a
  padding slot ``S``: mask True, score clipped to 0).  The two agree on
  every real pod and may differ on padding pods, which never bind.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from k8s1m_tpu_torch.ops import _build
from k8s1m_tpu_torch.ops.priority import JITTER_BITS

MAX_K = 128
POD_TILE = 128            # pods per CUDA block
TILE = 128                # columns per staged tile
BLOCKS_PER_SM = 8
_M32 = 0xFFFFFFFF

# Kernel arguments, in the order of csrc/delta_topk.cu's Ptr and Int enums.
_PTRS = ("pmask", "pscore", "slot", "order", "part_idx", "part_prio", "out_idx", "out_prio")
_INTS = ("s", "n", "b", "k", "seed", "row_base", "col_base", "stratum_bits", "splits")


def delta_plane_topk(pmask, pscore, slot_ids, seed, *, chunk: int, k: int,
                     stratum_bits: int = 0, row_offset: int = 0, pod_offset: int = 0):
    """``engine.cycle.Candidates`` of each pod's top ``k`` plane columns:
    ``idx`` global (column + ``row_offset``, -1 = none), ``prio``, and the
    payload columns zeroed (``deltacache.attach_payload`` fills them).

    ``seed`` is the wave's i32 seed (negative values enter as their
    uint32 pattern); ``row_offset``/``pod_offset`` bias the hash's node
    and pod coordinates and the emitted rows, as in the JAX wrapper.
    ``chunk`` must divide N (the JAX grid's column step; the result does
    not depend on it)."""
    from k8s1m_tpu_torch.engine.deltacache import plane_topk, without_payload

    n = pmask.shape[1]
    if n % chunk:
        raise ValueError(f"plane rows {n} not divisible by chunk {chunk}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if not 0 <= stratum_bits <= JITTER_BITS:
        raise ValueError(f"stratum_bits must be in [0, {JITTER_BITS}], got {stratum_bits}")
    seed = operator.index(seed)
    dev = pmask.device
    if dev.type == "cpu":
        return plane_topk(pmask, pscore, slot_ids, seed, chunk=chunk, k=k,
                          row_offset=row_offset, pod_offset=pod_offset,
                          stratum_bits=stratum_bits)
    if dev.type != "cuda":
        raise ValueError(f"delta_plane_topk runs on cuda or cpu tensors, got {dev}")
    idx, prio = _launch(pmask, pscore, slot_ids, seed, k=k, stratum_bits=stratum_bits,
                        row_base=pod_offset, col_base=row_offset)
    return without_payload(
        torch.where(prio >= 0, idx + row_offset, torch.full_like(idx, -1)), prio)


delta_plane_topk.launches = 0


def reset_launches() -> None:
    """Set the launch count of ``delta_plane_topk`` to 0."""
    delta_plane_topk.launches = 0


def _require(t: torch.Tensor, name: str, dtype, dev, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, planes on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def splits_for(b: int, n: int, sms: int) -> int:
    """Column splits per pod tile: about BLOCKS_PER_SM blocks per SM, no
    split shorter than one staged tile."""
    pod_tiles = -(-b // POD_TILE)
    return max(1, min(-(-BLOCKS_PER_SM * sms // pod_tiles), -(-n // TILE)))


def _launch(pmask, pscore, slot_ids, seed, *, k, stratum_bits, row_base, col_base):
    dev = pmask.device
    s, n = pmask.shape
    b = slot_ids.shape[0]
    if s < 1 or b < 1:
        raise ValueError(f"need at least one slot and one pod, got S={s}, B={b}")
    _require(pmask, "pmask", torch.bool, dev, (s, n))
    _require(pscore, "pscore", torch.int32, dev, (s, n))
    _require(slot_ids, "slot_ids", torch.int32, dev, (b,))
    i32 = torch.int32
    # Pods sorted by (clipped) slot: a block's 128 pods then share few
    # slots, and the kernel stages each of them once per tile.
    order = torch.argsort(slot_ids.clamp(0, s - 1), stable=True).to(i32)
    splits = splits_for(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out_idx = torch.empty((b, k), dtype=i32, device=dev)
    out_prio = torch.empty((b, k), dtype=i32, device=dev)
    ptrs = {
        "pmask": pmask, "pscore": pscore, "slot": slot_ids, "order": order,
        "part_idx": torch.empty((splits, b, k), dtype=i32, device=dev),
        "part_prio": torch.empty((splits, b, k), dtype=i32, device=dev),
        "out_idx": out_idx, "out_prio": out_prio,
    }
    ints = dict(s=s, n=n, b=b, k=k, seed=seed & _M32, row_base=int(row_base),
                col_base=int(col_base), stratum_bits=stratum_bits, splits=splits)
    p_arr = (ctypes.c_longlong * len(_PTRS))(*(ptrs[name].data_ptr() for name in _PTRS))
    i_arr = (ctypes.c_longlong * len(_INTS))(*(int(ints[name]) for name in _INTS))
    fn = _kernel_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p_arr, len(_PTRS), i_arr, len(_INTS), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"delta_topk kernel launch failed: cudaError {err}")
    delta_plane_topk.launches += 1
    return out_idx, out_prio


def blocks_per_sm(k: int) -> int:
    """Resident blocks per SM of the kernel instantiation a launch with
    this ``k`` uses (CUDA's occupancy calculator; needs the card)."""
    fn = _build.load("delta_topk").k8s_delta_blocks_per_sm
    fn.argtypes = (ctypes.c_int,)
    fn.restype = ctypes.c_int
    n = fn(k)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-n}")
    return n


def _kernel_entry():
    lib = _build.load("delta_topk")
    fn = lib.k8s_delta_topk
    if fn.argtypes is None:
        arr = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = (arr, ctypes.c_int, arr, ctypes.c_int, ctypes.c_void_p)
        fn.restype = ctypes.c_int
    return fn
