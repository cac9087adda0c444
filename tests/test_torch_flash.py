"""The port's flash_attention plain version against the JAX package, and
its wrapper and registry entry.

* The plain version (``repro_torch.kernels.flash_attention``, run by the
  wrapper on CPU tensors) against JAX's jnp oracle ``attention_ref`` and
  against the Pallas body in interpret mode (``ops.flash_attention(...,
  force=True)``), on the reference's five test shapes in f32: rtol 1e-4,
  atol 1e-5, the reference's own tolerance for its kernel against its
  oracle (the three sum in different orders).
* bf16 against the f32 oracle at 3e-2, as the reference tests its kernel.
* Causality, a ragged S, strided (transposed) inputs.
* The wrapper raises on what the kernel does not take; on CPU tensors it
  counts no launch.  The registry resolves ``ref`` on CPU tensors and
  raises for a forced ``cuda``.

The CUDA kernel against its plain version is in ``test_torch_cuda.py``
(card only) and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro_torch.core import trace_execution
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from strategies import Draw

JAX_SHAPES = [(1, 2, 1, 128, 64, True), (2, 4, 2, 256, 64, True),
              (1, 8, 1, 128, 128, False), (1, 2, 2, 64, 32, True),
              (1, 4, 4, 128, 64, True)]


def _qkv(seed, b, hq, hk, s, d):
    draw = Draw(seed)
    return (draw.normal((b, hq, s, d)), draw.normal((b, hk, s, d)),
            draw.normal((b, hk, s, d)))


def _port(q, k, v, causal=True, dtype=torch.float32):
    out = fa_ops.flash_attention(*(torch.from_numpy(a).to(dtype)
                                   for a in (q, k, v)), causal=causal)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("b,hq,hk,s,d,causal", JAX_SHAPES)
def test_plain_matches_jax_oracle_and_pallas_body(b, hq, hk, s, d, causal):
    q, k, v = _qkv(s * hq + d, b, hq, hk, s, d)
    got = _port(q, k, v, causal)
    want = np.asarray(jfa_ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0 / d ** 0.5,
        causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    body = np.asarray(jfa_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        tile_q=min(64, s), tile_k=min(64, s), force=True))
    np.testing.assert_allclose(got, body, rtol=1e-4, atol=1e-5)


def test_plain_bf16():
    q, k, v = _qkv(7, 1, 2, 1, 128, 64)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = fa_ops.flash_attention(*bf)
    assert got.dtype == torch.bfloat16
    # the oracle in f32 on the same bf16-rounded inputs
    want = np.asarray(jfa_ref.attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in bf), scale=1.0 / 8.0))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def test_plain_causality():
    """Perturbing keys and values from position 40 on leaves the outputs
    before 40 as they are, and moves those after."""
    q, k, v = _qkv(11, 1, 2, 1, 64, 32)
    base = _port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 40:] += 10.0
    v2[:, :, 40:] += 10.0
    pert = _port(q, k2, v2)
    np.testing.assert_allclose(base[:, :, :40], pert[:, :, :40], rtol=1e-5,
                               atol=1e-6)
    assert float(np.max(np.abs(base[:, :, 41:] - pert[:, :, 41:]))) > 1e-3


@pytest.mark.parametrize("s", [1, 100])
def test_plain_ragged_s_matches_jax_oracle(s):
    """The kernel takes any S; the reference's wrapper needs S to be a
    multiple of its tile, its oracle does not."""
    q, k, v = _qkv(s, 2, 4, 2, s, 64)
    want = np.asarray(jfa_ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1 / 8.0))
    np.testing.assert_allclose(_port(q, k, v), want, rtol=1e-4, atol=1e-5)


def test_strided_inputs_match_contiguous():
    """(B, S, H, D) tensors seen through transpose(1, 2), as the model
    passes them, give what their contiguous copies give."""
    draw = Draw(3)
    q = torch.from_numpy(draw.normal((2, 96, 4, 32))).transpose(1, 2)
    k = torch.from_numpy(draw.normal((2, 96, 2, 32))).transpose(1, 2)
    v = torch.from_numpy(draw.normal((2, 96, 2, 32))).transpose(1, 2)
    assert not q.is_contiguous()
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert torch.equal(got, want)


def test_wrapper_on_cpu_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 1, 16, 8))
    before = fa_ops.flash_attention_launches
    fa_ops.flash_attention(q, k, v)
    assert fa_ops.flash_attention_launches == before


@pytest.mark.parametrize("case", ["d_over_128", "group", "dtype", "shape",
                                  "rank"])
def test_wrapper_rejects(case):
    q = torch.zeros((1, 4, 8, 16))
    k = v = torch.zeros((1, 2, 8, 16))
    if case == "d_over_128":
        q, k, v = (torch.zeros((1, h, 8, 160)) for h in (4, 2, 2))
    elif case == "group":
        k = v = torch.zeros((1, 3, 8, 16))
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "shape":
        k = v = torch.zeros((1, 2, 9, 16))
    else:
        q = torch.zeros((4, 8, 16))
    with pytest.raises((ValueError, TypeError)):
        fa_ops.flash_attention(q, k, v)


def test_registry_resolves_ref_on_cpu_and_rejects_forced_cuda():
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 4, 2, 32, 16))
    with trace_execution() as tr:
        out = registry.dispatch("flash_attention", q, k, v, causal=True)
    assert [(e.engine, e.detail["name"]) for e in tr.kernels] == [
        ("ref", "flash_attention")]
    assert torch.equal(out, fa_ref.flash_attention_ref(q, k, v))
    assert "flash_attention" in registry.available()
    with pytest.raises(ValueError, match="only on the card"):
        registry.dispatch("flash_attention", q, k, v, impl="cuda")


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 96, "tc"),
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 16, "tc"),
    (torch.bfloat16, 8, "tc"), (torch.bfloat16, 20, "ffma"),
    (torch.bfloat16, 1, "ffma"), (torch.float32, 128, "ffma"),
    (torch.float32, 16, "ffma")])
def test_wrapper_picks_the_kernel_by_dtype_and_d(dtype, d, kernel):
    """Dense bf16 with D % 8 == 0 -> the tensor-core kernel; f32, and bf16
    with D % 8 != 0 (TMA's 16-byte rows) -> the FFMA kernel."""
    t = torch.zeros((2, 3, 5, d), dtype=dtype)
    assert fa_ops.kernel_for(t, t, t, torch.empty_like(t)) == kernel


def test_every_dense_config_takes_the_tensor_core_kernel():
    """Every D of the configs the port serves (dense: 128, 96, 64; the
    reduced configs' 16, cast to bf16) goes through the tensor cores in
    bf16, also as the model's (B, S, H, D) projections seen through
    ``transpose(1, 2)``."""
    from repro_torch.configs import ARCHS, get_config, reduced_config
    dense = [a for a in ARCHS if get_config(a).family == "dense"]
    assert dense
    for arch in dense:
        cfg = get_config(arch)
        assert cfg.dtype == "bfloat16"
        for d in (cfg.d_head, reduced_config(arch).d_head):
            t = torch.zeros((2, 7, 4, d), dtype=torch.bfloat16)
            assert fa_ops.kernel_for(t.transpose(1, 2)) == "tc", (arch, d)


def test_tma_strides():
    """The tensor-core kernel's strides: a (B, S, H, D) view keeps its
    own; an axis of size 1 takes a contiguous tensor's; a used stride
    that is not a multiple of 8 elements gives None."""
    t = torch.zeros((2, 9, 4, 16), dtype=torch.bfloat16).transpose(1, 2)
    assert fa_ops.tma_strides(t) == [576, 16, 64]
    one = torch.zeros((1, 4, 3, 24), dtype=torch.bfloat16)[:, :, :1]
    assert fa_ops.tma_strides(one) == [96, 72, 24]
    assert fa_ops.tma_strides(torch.zeros((2, 4, 9, 20),
                                          dtype=torch.bfloat16)[..., :16]) \
        is None


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
@pytest.mark.parametrize("layout", ["stride", "pointer"])
def test_wrapper_sends_bf16_tma_cannot_read_to_ffma(which, layout):
    """bf16 with D % 8 == 0 that TMA cannot read, in any one of q, k, v
    or the output, takes the FFMA kernel, which reads any strides: a
    position stride of 20 elements, or a data pointer 2 bytes past 16."""
    dense = torch.zeros((1, 4, 9, 16), dtype=torch.bfloat16)
    if layout == "stride":
        odd = torch.zeros((1, 4, 9, 20), dtype=torch.bfloat16)[..., :16]
    else:
        odd = torch.zeros(1 + dense.numel(),
                          dtype=torch.bfloat16)[1:].view(dense.shape)
    assert fa_ops.tma_strides(odd) is None
    ts = {"q": dense, "k": dense, "v": dense, "out": dense, which: odd}
    assert fa_ops.kernel_for(ts["q"], ts["k"], ts["v"], ts["out"]) == "ffma"
