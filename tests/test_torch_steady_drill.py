"""The port's composed steady-state drill (``tools/steady_drill.py``) against
the JAX package's, on the CPU: the three lanes the JAX tests run
(``--smoke``, ``--smoke --mesh 2x4``, ``--smoke --failover``), each with
``--device cpu``.

Both drills run on a tick-driven injected clock, so their reports are
deterministic by seed except for the warm takeover's host seconds
(``recovery_s``, failover lane): two runs of the JAX drill at the same
seed differ in that key alone.  The port's report must pass and equal the
JAX drill's once that key, and the port's own ``device`` and ``phase_s``
(host seconds per stretch of the run) keys, are removed:
the weights, admitted and rejected counts per tenant, lost pods, loadshed
states, recovery tick, churn, quiesces, in-flight depths, staged batches,
injected faults, give-ups, mesh scatters, packing fallbacks and the
failover lane's kill, takeover mode and watch-tier counts (events, client
cancels and errors, resumes, invalidations).

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import pytest

from k8s1m_tpu.tools import steady_drill as jax_drill
from k8s1m_tpu_torch.tools import steady_drill as port_drill

# Host wall-clock seconds (the failover lane's takeover, the port's phase times) and
# the port's device: the only keys the comparison leaves out.
CLOCK_KEYS = ("recovery_s", "phase_s")
DEVICE_KEYS = ("device",)
LANES = {"smoke": [], "mesh": ["--mesh", "2x4"], "failover": ["--failover"]}


def _scrub(d):
    if isinstance(d, dict):
        return {k: _scrub(v) for k, v in d.items() if k not in CLOCK_KEYS + DEVICE_KEYS}
    return d


@pytest.mark.parametrize("lane", sorted(LANES))
def test_steady_drill_equals_jax(lane, tmp_path):
    argv = ["--smoke", *LANES[lane]]
    jax_res = jax_drill.main([*argv, "--out", str(tmp_path / "jax.json")])
    port_res = port_drill.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert jax_res["passed"], jax_res
    assert port_res["passed"], port_res
    assert port_res["device"] == "cpu"
    assert _scrub(port_res) == _scrub(jax_res)
    ev = port_res["evidence"]
    if lane == "mesh":
        assert ev["mesh"] == "2x4" and ev["mesh_sharded_scatters"]["cap"] > 0
    if lane == "failover":
        fo = ev["failover"]
        assert fo["kill_fired"] == 1 and fo["beta_leader"] and fo["takeover_mode"] == "warm"
        tier = fo["watch_tier"]
        assert tier["resumes"] >= 1 and tier["invalidations"] == 0
        assert tier["client_cancels"] == 0 and tier["client_errors"] == 0 and tier["events"] > 0
