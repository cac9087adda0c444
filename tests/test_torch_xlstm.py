"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the CPU in f32, at the reduced xlstm-350m config.

Weights come from the reference's ``init_mlstm``/``init_slstm`` (the
gate weights redrawn at std 0.1, so that the exponential gates and the
stabilisers m move away from their init) and cross as numpy arrays;
activations are numpy draws.  Tolerances:

* against JAX, rtol = atol = 1e-5: the order of operations is the
  reference's, and the libraries differ only in how their matmuls and
  einsums sum f32 products;
* the port's mLSTM decode against its own chunked prefill, rtol = atol
  = 1e-4: the recurrence and the chunk form are the same function
  computed through other sums and exponentials.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import xlstm as JXL
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.models import xlstm as XL
from strategies import Draw

RTOL = ATOL = 1e-5
ARCH = "xlstm-350m"


def _pair(kind, seed=0):
    cfg, jcfg = tbase.reduced_config(ARCH), jbase.reduced_config(ARCH)
    store = JL.ParamStore(jax.random.PRNGKey(seed), jnp.float32)
    getattr(JXL, f"init_{kind}")(store, jcfg, kind)
    jp = jax.tree.map(np.asarray, store.params[kind])
    gate = "w_if" if kind == "mlstm" else "r_gates"
    jp[gate] = Draw(seed + 60).normal(jp[gate].shape) * 0.1
    mod = (XL.MLSTM if kind == "mlstm" else XL.SLSTM)(cfg, torch.float32,
                                                       "cpu")
    params_from_numpy(mod, jp)
    return cfg, jcfg, mod, jax.tree.map(jnp.asarray, jp)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _state_close(got, want):
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k])


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 256), (1, 256)])
def test_run_mlstm_matches_jax(s, chunk):
    """Four chunks of 8 (the state carried across three boundaries), one
    chunk of the whole, and one token."""
    cfg, jcfg, mod, jp = _pair("mlstm")
    x = Draw(s).normal((2, s, cfg.d_model))
    got = XL.run_mlstm(mod, cfg, torch.from_numpy(x), chunk=chunk)
    want = JXL.run_mlstm(jp, jcfg, jnp.asarray(x), chunk=chunk)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_run_mlstm_rejects_a_ragged_chunk():
    cfg, _, mod, _ = _pair("mlstm")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        XL.run_mlstm(mod, cfg, torch.zeros((1, 12, cfg.d_model)), chunk=8)


def test_run_mlstm_decode_matches_jax():
    """Twelve steps from the init state (m = -1e30: no NaN), the state
    compared at each; the steps against the chunked prefill."""
    cfg, jcfg, mod, jp = _pair("mlstm", 1)
    x = Draw(5).normal((2, 12, cfg.d_model))
    state = XL.init_mlstm_state(cfg, 2)
    jstate = JXL.init_mlstm_state(jcfg, 2)
    _state_close(state, jstate)
    outs = []
    for t in range(12):
        got, state = XL.run_mlstm_decode(mod, cfg,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         state)
        want, jstate = JXL.run_mlstm_decode(jp, jcfg,
                                            jnp.asarray(x[:, t:t + 1]),
                                            jstate)
        _close(got, want)
        _state_close(state, jstate)
        outs.append(got)
    whole = XL.run_mlstm(mod, cfg, torch.from_numpy(x), chunk=4)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_run_slstm_matches_jax():
    """The time loop over 24 steps from the init state, and resumed."""
    cfg, jcfg, mod, jp = _pair("slstm")
    x = Draw(6).normal((2, 24, cfg.d_model))
    got, state = XL.run_slstm(mod, cfg, torch.from_numpy(x))
    want, jstate = JXL.run_slstm(jp, jcfg, jnp.asarray(x))
    _close(got, want)
    _state_close(state, jstate)
    got, state = XL.run_slstm(mod, cfg, torch.from_numpy(x), state=state)
    want, jstate = JXL.run_slstm(jp, jcfg, jnp.asarray(x), state=jstate)
    _close(got, want)
    _state_close(state, jstate)


def test_run_slstm_decode_matches_jax():
    cfg, jcfg, mod, jp = _pair("slstm", 1)
    x = Draw(7).normal((2, 10, cfg.d_model))
    state = XL.init_slstm_state(cfg, 2)
    jstate = JXL.init_slstm_state(jcfg, 2)
    _state_close(state, jstate)
    outs = []
    for t in range(10):
        got, state = XL.run_slstm_decode(mod, cfg,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         state)
        want, jstate = JXL.run_slstm_decode(jp, jcfg,
                                            jnp.asarray(x[:, t:t + 1]),
                                            jstate)
        _close(got, want)
        _state_close(state, jstate)
        outs.append(got)
    whole, _ = XL.run_slstm(mod, cfg, torch.from_numpy(x))
    _close(torch.cat(outs, 1), whole)
