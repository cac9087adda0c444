"""The port's serving entry point (``repro_torch.launch.serve``) on the
CPU, at the reduced configs of every decoder family: shapes, counts, the sampler's
determinism and the device policy.  Its logits are those of ``decode_step``, which
``test_torch_models.py`` holds against JAX."""

import sys

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import serve as S
from repro_torch.models import model as M


@pytest.mark.parametrize("arch", ["qwen3-8b", "stablelm-1.6b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b",
                                  "recurrentgemma-2b", "qwen2-vl-2b",
                                  "xlstm-350m"])
def test_serve_on_cpu(arch):
    toks, timings = S.serve(arch, batch=3, prompt_len=5, gen_len=7,
                            device="cpu")
    vocab = reduced_config(arch).vocab
    assert toks.shape == (3, 7) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    assert set(timings) == {"prefill_s", "prefill_tok_s", "decode_s",
                            "decode_tok_s"}
    assert all(v > 0 for v in timings.values())
    assert timings["decode_tok_s"] == pytest.approx(
        3 * 7 / timings["decode_s"])


def test_serve_is_seeded():
    a, _ = S.serve("qwen3-8b", batch=2, prompt_len=4, gen_len=6, seed=1,
                   device="cpu")
    b, _ = S.serve("qwen3-8b", batch=2, prompt_len=4, gen_len=6, seed=1,
                   device="cpu")
    c, _ = S.serve("qwen3-8b", batch=2, prompt_len=4, gen_len=6, seed=2,
                   device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_serve_low_temperature_is_greedy():
    """At a temperature near 0 the sampler takes the argmax: each token is
    the argmax of the logits its predecessors give, which a second decode
    of the same prompt reproduces."""
    toks, _ = S.serve("qwen3-8b", batch=2, prompt_len=4, gen_len=5,
                      temperature=1e-4, seed=3, device="cpu")
    cfg = reduced_config("qwen3-8b")
    gen = torch.Generator().manual_seed(3)
    model = M.init_model(cfg, generator=gen, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 4), generator=gen)
    state = M.init_decode_state(cfg, 2, 9, device="cpu")
    for t in range(4):
        logits, state = M.decode_step(model, state, prompt[:, t:t + 1], t)
    cur = torch.argmax(logits, -1)[:, None]
    for t in range(4, 9):
        logits, state = M.decode_step(model, state, cur, t)
        cur = torch.argmax(logits, -1)[:, None]
        assert torch.equal(cur[:, 0], toks[:, t - 4])


def test_serve_rejects():
    """The encoder-only family has no decode path (every decoder family
    serves: ``test_serve_on_cpu``)."""
    with pytest.raises(ValueError, match="encoder-only"):
        S.serve("hubert-xlarge", device="cpu")


def test_serve_needs_a_card_or_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        S.serve("qwen3-8b")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-8b"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        S.main()
