"""The port's heartbeat monitor and elastic mesh plan
(``distributed/fault_tolerance.py``) against the JAX package's, which are
pure Python: the same fake-clock traces and a grid of device counts give
equal answers."""

import pytest

from repro.distributed import fault_tolerance as JF
from repro_torch.distributed import fault_tolerance as F

# (time, event) traces: ("beat", host) records a beat, ("sweep",) sweeps
TRACES = {
    "reference": [(25.0, "beat", "h0"), (25.0, "beat", "h1"),
                  (25.0, "sweep"), (35.0, "sweep")],
    "late_beat_revives_nothing": [(31.0, "sweep"), (40.0, "beat", "h2"),
                                  (41.0, "sweep"), (75.0, "sweep")],
    "all_die_then_one_beats": [(12.0, "sweep"), (29.9, "sweep"),
                               (30.0, "sweep"), (31.0, "beat", "h1"),
                               (90.0, "sweep")],
    "steady": [(t, "beat", h) for t in (5.0, 15.0, 25.0, 35.0)
               for h in ("h0", "h1", "h2")] + [(36.0, "sweep")],
}


def _run(mod, trace, interval, max_missed):
    t = [0.0]
    mon = mod.HeartbeatMonitor(["h0", "h1", "h2"], interval=interval,
                               max_missed=max_missed, clock=lambda: t[0])
    out = []
    for now, what, *host in trace:
        t[0] = now
        if what == "beat":
            mon.beat(host[0])
        else:
            out.append(mon.sweep())
        out.append((mon.alive_hosts,
                    {h: (st.missed, st.alive, st.last_beat)
                     for h, st in mon.hosts.items()}))
    return out


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("interval,max_missed", [(10.0, 3), (4.0, 1)])
def test_heartbeat_monitor_matches_jax(name, interval, max_missed):
    assert (_run(F, TRACES[name], interval, max_missed)
            == _run(JF, TRACES[name], interval, max_missed))


@pytest.mark.parametrize("model_parallel", [1, 2, 16])
@pytest.mark.parametrize("pods", [1, 2, 3])
def test_plan_elastic_mesh_matches_jax(model_parallel, pods):
    for n in list(range(0, 40)) + [255, 256, 384, 511, 512]:
        assert (F.plan_elastic_mesh(n, model_parallel=model_parallel,
                                    pods=pods)
                == JF.plan_elastic_mesh(n, model_parallel=model_parallel,
                                        pods=pods))


def test_host_state_defaults():
    st = F.HostState(last_beat=3.0)
    assert (st.missed, st.alive) == (0, True)
