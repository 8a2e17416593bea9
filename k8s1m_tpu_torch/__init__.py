"""k8s1m_tpu_torch — the PyTorch/CUDA port of k8s1m_tpu for one NVIDIA H100.

The package mirrors ``k8s1m_tpu``'s layout module for module, so each
port has an obvious counterpart, and holds itself to byte-identity with
it on the same inputs: the same candidate ``idx``/``prio``, the same
bound rows, the same table after commit.  It imports ``torch`` and
numpy only — never JAX, and nothing of ``k8s1m_tpu``.

It carries the packed scheduling wave
(``engine.cycle.schedule_batch_packed``) with every plugin stage of the
fused kernel — the base plugins, NodeAffinity, and the PodTopologySpread /
InterPodAffinity constraint stage over count tables:

- ``snapshot``  — host numpy mirrors and device tensor tables (plain and
                  packed layouts), the pod-batch encoder, the constraint
                  count tables;
- ``ops``       — the tie-break hash, label matching, and the fused
                  filter+score+top-K, a hand-written CUDA kernel
                  (``csrc/fused_topk*.cu``) with its plain PyTorch version
                  beside it;
- ``plugins``   — the profile, NodeAffinity filter/score and the topology
                  prologue/filter/score in plain PyTorch;
- ``engine``    — the greedy in-batch conflict scan and the wave;
- ``cluster``   — the KWOK fleet, the workloads of BASELINE configs 1-4 and
                  the fleets the kernel is checked on;
- ``interop``   — converters from the JAX package's state (as numpy).

Entry points take ``device="cuda"`` unless the caller asks for
``device="cpu"``; a missing card raises (``device.resolve_device``).
"""

__version__ = "0.1.0"
