"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's, on the CPU in f32, at the reduced recurrentgemma-2b config.

Weights come from the reference's ``init_rglru`` (``lam`` redrawn so that
the decay a = sigmoid(8 lam) spreads over (0, 1), where the ones of the
init give one decay for every channel) and cross as numpy arrays;
activations are numpy draws.  Tolerances:

* decode and the conv, whose order of operations is the reference's:
  rtol = atol = 1e-5;
* the prefill, whose recurrence is a Hillis-Steele scan where XLA's
  ``associative_scan`` builds another tree of the same combine: the
  log-decays are summed, and the states multiplied by exp of those sums,
  in other groupings.  Each level re-rounds, and a decay near 1 carries
  a rounding over ~1/(1 - a) steps, so the difference grows with S: up
  to 1e-5 on states and outputs of about 2-3 at S = 64 over four seeds
  (5e-5 at S = 512).  rtol = atol = 1e-4 for S <= 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import rglru as JRG
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.models import rglru as RG
from strategies import Draw

RTOL = ATOL = 1e-5
SCAN_TOL = 1e-4


def _pair(seed=0):
    arch = "recurrentgemma-2b"
    cfg, jcfg = tbase.reduced_config(arch), jbase.reduced_config(arch)
    store = JL.ParamStore(jax.random.PRNGKey(seed), jnp.float32)
    JRG.init_rglru(store, jcfg, "rglru")
    jp = jax.tree.map(np.asarray, store.params["rglru"])
    draw = Draw(seed + 50)
    jp["lam"] = draw.normal((cfg.d_model,)) * 0.5
    jp["conv_b"] = draw.normal((cfg.d_model,)) * 0.1
    mod = RG.RGLRU(cfg, torch.float32, "cpu")
    params_from_numpy(mod, jp)
    return cfg, jcfg, mod, jax.tree.map(jnp.asarray, jp)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_run_rglru_matches_jax(s):
    cfg, jcfg, mod, jp = _pair()
    x = Draw(s).normal((2, s, cfg.d_model))
    got, (h, conv) = RG.run_rglru(mod, cfg, torch.from_numpy(x))
    want, (jh, jconv) = JRG.run_rglru(jp, jcfg, jnp.asarray(x))
    _close(got, want, SCAN_TOL)
    _close(h, jh, SCAN_TOL)
    _close(conv, jconv, RTOL)


def test_run_rglru_resumes_from_state_as_jax():
    """A prefill of 40 tokens resumed from the state after 24 (the h0
    injection and the conv state), against JAX and against the
    uninterrupted 64-token prefill."""
    cfg, jcfg, mod, jp = _pair(1)
    x = Draw(3).normal((2, 64, cfg.d_model))
    _, state = RG.run_rglru(mod, cfg, torch.from_numpy(x[:, :24]))
    got, (h, conv) = RG.run_rglru(mod, cfg, torch.from_numpy(x[:, 24:]),
                                  state=state)
    _, jstate = JRG.run_rglru(jp, jcfg, jnp.asarray(x[:, :24]))
    want, (jh, jconv) = JRG.run_rglru(jp, jcfg, jnp.asarray(x[:, 24:]),
                                      state=jstate)
    _close(got, want, SCAN_TOL)
    _close(h, jh, SCAN_TOL)
    _close(conv, jconv, RTOL)
    whole, _ = RG.run_rglru(mod, cfg, torch.from_numpy(x))
    _close(got, whole[:, 24:], SCAN_TOL)


def test_run_rglru_decode_matches_jax():
    """Eight decode steps from a prefill's state, h and conv compared at
    every step; and the steps against the prefill of the whole."""
    cfg, jcfg, mod, jp = _pair(2)
    x = Draw(4).normal((2, 12, cfg.d_model))
    _, (h, conv) = RG.run_rglru(mod, cfg, torch.from_numpy(x[:, :4]))
    _, (jh, jconv) = JRG.run_rglru(jp, jcfg, jnp.asarray(x[:, :4]))
    # both from JAX's state
    h, conv = (torch.from_numpy(np.array(a)) for a in (jh, jconv))
    outs = []
    for t in range(4, 12):
        got, (h, conv) = RG.run_rglru_decode(
            mod, cfg, torch.from_numpy(x[:, t:t + 1]), (h, conv))
        want, (jh, jconv) = JRG.run_rglru_decode(
            jp, jcfg, jnp.asarray(x[:, t:t + 1]), (jh, jconv))
        _close(got, want, RTOL)
        _close(h, jh, RTOL)
        _close(conv, jconv, RTOL)
        outs.append(got)
    whole, _ = RG.run_rglru(mod, cfg, torch.from_numpy(x))
    _close(torch.cat(outs, 1), whole[:, 4:], SCAN_TOL)

