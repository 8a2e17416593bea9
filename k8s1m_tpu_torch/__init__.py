"""k8s1m_tpu_torch — the PyTorch/CUDA port of k8s1m_tpu for one NVIDIA H100.

The package mirrors ``k8s1m_tpu``'s layout module for module, so each
port has an obvious counterpart, and holds itself to byte-identity with
it on the same inputs: the same candidate ``idx``/``prio``, the same
bound rows, the same table after commit.  It imports ``torch`` and
numpy only — never JAX, and nothing of ``k8s1m_tpu``.

It carries the host coordinator and, under it, the packed scheduling wave
(``engine.cycle.schedule_batch_packed``) with every plugin stage of the
fused kernel — the base plugins, NodeAffinity, and the PodTopologySpread /
InterPodAffinity constraint stage over count tables — and the deltasched
wave (``engine.cycle.schedule_batch_delta``, ``fill_shape_planes``) over
cached per-shape feasibility/score planes, with its candidate index:

- ``snapshot``  — host numpy mirrors and device tensor tables (plain and
                  packed layouts), row scatters and the row-version
                  journal, the pod-batch encoder, shape keys, the
                  constraint count tables;
- ``ops``       — the tie-break hash, label matching, the fused
                  filter+score+top-K (``csrc/fused_topk*.cu``) and the
                  delta plane tail (``csrc/delta_topk.cu``), hand-written
                  CUDA kernels with their plain PyTorch versions beside them;
- ``plugins``   — the profile, the filter and score plugins and
                  ``score_and_filter`` (the XLA path the planes hold), the
                  topology prologue/filter/score, in plain PyTorch;
- ``engine``    — the greedy in-batch conflict scan, the waves and the
                  deltasched plane cache;
- ``cluster``   — the KWOK fleet, the workloads of BASELINE configs 1-4 and
                  the fleets the kernel is checked on;
- ``control``   — the host coordinator (store -> watch -> wave -> CAS bind)
                  and the Kubernetes object codec;
- ``store``     — ctypes bindings of the native in-process store (the
                  port's own ``libmemstore.so``, built from ``native/``);
- ``obs``, ``faultline`` — the coordinator's metrics registry and retry
                  policy;
- ``tools``     — ``sched_bench``, the coordinator's end-to-end entry point;
- ``interop``   — converters from the JAX package's state (as numpy).

Entry points take ``device="cuda"`` unless the caller asks for
``device="cpu"``; a missing card raises (``device.resolve_device``).
"""

__version__ = "0.1.0"
